// K8: landmark-grouped Schur reduction of the windowed bundle adjustment
// and the landmark back-substitution.
//
// Replaces visual_sgraphs_tpu/parallel/dist_ba.py::_landmark_terms,
// ::_local_reduced_system, ::_inv3x3 and ::_back_substitute.  The JAX
// version turns every contraction into a matmul over a one-hot (n, O, K)
// keyframe assignment (the TPU's matrix unit; a scatter serialised there).
//
// What bounds it here: latency.  The local BA's call (n = 8,192 table
// rows, O = 12, L = 11) needs ~2 MB of tables read and the (n, O, 6, 3) W
// cache written, and ~60 M FMAs of pair sums: a few microseconds of the
// card either way.  The previous design spent its time in three device
// operations (a memset, the reduction, a symmetrising pass) and in float
// atomics: shared ones a pair product, then every block flushing its whole
// (6L)^2 accumulator into global memory with an atomic an entry, so S and
// rhs changed from run to run.
//
// Design: one launch, no memset, no float atomics, sums in an order fixed
// by the data (gram.cuh).  Rows without a valid observation get their
// outputs from one thread and no further work.  A segment of 8-32 lanes
// builds one landmark, an observation a lane (any O, SEG at a time):
// residual (projected in float64: a converged window's residuals are
// ~1e-4 px, below float32's resolution of a pixel coordinate), Jacobians
// and robust weight in float32; segment sums give Hxx, bx and the cost;
// the damped Hxx's closed-form inverse (the Hinv output) and Cholesky
// factor; the W rows go out through shared memory, coalesced; the
// observations of one slot collapse into P_s = sum W (transposed), its Hpp
// block and gradient; B_s = L^-1 P_s^T, so that the
// pair blocks W_a Hinv W_b^T summed over a landmark's observations are
// B_s^T B_t, and rhs_s = P_s Hinv bx - gp_s.  FP32 products (the terms
// span about eight orders of magnitude: no TF32 and no tensor cores); the
// cross-CTA sums in FP64.
// - L <= ~52 (the local and scene-graph BAs): its 576 threads own the
//   entries of the upper-triangle slot-pair blocks of S (each landmark
//   adds Hpp_s - B_s^T B_t), rhs and the cost, in shared memory, landmark
//   by landmark; clusters of 8 CTAs reduce the CTAs' partials through
//   distributed shared memory, the last cluster to finish a slice sums the
//   clusters' rows.  S is written mirrored, exactly symmetric.
// - Larger L (the global BA, L = 128, whose (6L)^2 sums do not fit a CTA):
//   one cooperative launch in two phases split by a grid barrier: (1) the
//   landmarks' staged terms and slot lists to global scratch
//   (L2-resident) and a per-slot bitmap of the observing landmarks (a CTA
//   owns 32-landmark groups, so it writes whole words); (2) a CTA a slot
//   row s: its landmarks, listed from the bitmap in order, dealt to 8
//   warps in turn; a warp copies a few landmarks' records to shared
//   memory asynchronously and adds each one's blocks (s, t >= s), a lane
//   an entry, into its own row accumulator; the accumulators are summed
//   in warp order and the row written (and mirrored), with the slot's
//   rhs.
// The back-substitution is one thread per landmark.
#include <cuda_pipeline_primitives.h>

#include "gram.cuh"

namespace {

using gram::FULL;
using gram::Q_B;
using gram::Q_G;
using gram::Q_H;
using gram::Q_P;
using gram::Q_R;
using gram::QS;
using gram::THREADS;
using gram::WARPS;

// floats of a staged entry in the global scratch: B (18) | block (21) |
// rhs (6), the stage's [Q_B, Q_G)
constexpr int BIG_QS = Q_G - Q_B;

// words of a segment's stage and, after it, its W rows (SEG x 18 floats,
// 8-byte aligned: the rows go out as float2)
__host__ __device__ __forceinline__ int stage_w_off(int L, int Qmax) {
    return (gram::stage_words(L, Qmax) + 1) & ~1;
}
__host__ __device__ __forceinline__ int stage_stride(int L, int Qmax,
                                                     int seg) {
    return stage_w_off(L, Qmax) + 18 * seg;
}

__device__ unsigned g_schur_tickets[gram::CLUSTER];
__device__ unsigned g_schur_bar[2];

struct SchurArgs {
    const float* pose;  // (L, 7) T_cw
    const float* pts;   // (n, 3)
    const int* kf_tab;  // (n, O)
    const float* uvr;   // (n, O, 3)
    const uint8_t* val;
    const float* cam_K;
    const float* bf;
    int n, O, L;
    float lam, huber;
    float* S;
    float* rhs;
    float* Hinv;
    float* bx;
    float* W;
    float* cost;
};

// The closed-form inverse of Hxx (upper 6 of hs) damped as the reference
// damps it, and the damping of each diagonal entry.
__device__ __forceinline__ void damped_inverse(const float* hs, float lam,
                                               float (&Hi)[3][3],
                                               float (&d)[3]) {
    float H[3][3] = {{hs[0], hs[1], hs[2]},
                     {hs[1], hs[3], hs[4]},
                     {hs[2], hs[4], hs[5]}};
    for (int i = 0; i < 3; ++i) {
        d[i] = lam * fmaxf(H[i][i], 1e-6f) + 1e-5f;
        H[i][i] += d[i];
    }
    const float a = H[0][0], b = H[0][1], c = H[0][2], e = H[1][1],
                f = H[1][2], g = H[2][0], h = H[2][1], k = H[2][2],
                dd = H[1][0];
    const float cA = e * k - f * h, cB = c * h - b * k, cC = b * f - c * e,
                cD = f * g - dd * k, cE = a * k - c * g, cF = c * dd - a * f,
                cG = dd * h - e * g, cH = b * g - a * h, cI = a * e - b * dd;
    const float det = a * cA + b * cD + c * cG;
    const float inv = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
    Hi[0][0] = cA * inv;
    Hi[0][1] = cB * inv;
    Hi[0][2] = cC * inv;
    Hi[1][0] = cD * inv;
    Hi[1][1] = cE * inv;
    Hi[1][2] = cF * inv;
    Hi[2][0] = cG * inv;
    Hi[2][1] = cH * inv;
    Hi[2][2] = cI * inv;
}

// Whether row lm has an observation that counts (valid, slot in range);
// four entries' loads in flight at a time.
__device__ __forceinline__ bool has_obs(const SchurArgs& a, int lm) {
    bool any = false;
    for (int o0 = 0; o0 < a.O; o0 += 4) {
        int k[4];
        uint8_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int o = o0 + u < a.O ? lm * a.O + o0 + u : lm * a.O;
            k[u] = a.kf_tab[o];
            v[u] = o0 + u < a.O ? a.val[o] : 0;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) any |= v[u] && k[u] >= 0 && k[u] < a.L;
    }
    return any;
}

// The outputs of a row without one: Hxx = 0, damped.
__device__ void empty_row(const SchurArgs& a, int lm) {
    const float hs[6] = {};
    float Hi[3][3], d[3];
    damped_inverse(hs, a.lam, Hi, d);
    for (int i = 0; i < 3; ++i) {
        a.bx[3 * lm + i] = 0.0f;
        for (int j = 0; j < 3; ++j) a.Hinv[9 * lm + 3 * i + j] = Hi[i][j];
    }
    float4* w = reinterpret_cast<float4*>(a.W + 18 * (size_t)lm * a.O);
    if ((reinterpret_cast<uintptr_t>(w) & 15) == 0 && (18 * a.O) % 4 == 0) {
        for (int t = 0; t < 18 * a.O / 4; ++t) {
            w[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int t = 0; t < 18 * a.O; ++t) a.W[18 * (size_t)lm * a.O + t] = 0.f;
    }
}

// One listed landmark (lm < 0: none) by one segment of SEG lanes (every
// lane of the warp calls): writes its Hinv, bx and W rows and stages its
// per-slot terms (header: entries, cost).
template <int SEG>
__device__ void schur_landmark(const SchurArgs& a, int lm, gram::Stage st,
                               float* wst, int lane) {
    const int sl = lane % SEG;
    const bool act = lm >= 0;
    gram::stage_reset<SEG>(st, a.L, lane);
    const double fx = a.cam_K[0], fy = a.cam_K[1], cx = a.cam_K[2],
                 cy = a.cam_K[3];
    const float bf = *a.bf;
    const int lmc = act ? lm : 0;
    const float X0 = a.pts[3 * lmc], X1 = a.pts[3 * lmc + 1],
                X2 = a.pts[3 * lmc + 2];
    float hs[10] = {};  // Hxx (upper 6), bx, cost
    double hbx[3] = {0.0, 0.0, 0.0};  // bx, summed in float64
    int nq = 0;
    for (int o0 = 0; o0 < a.O; o0 += SEG) {
        const int o = o0 + sl;
        const bool live = act && o < a.O;
        float r[3] = {0.f, 0.f, 0.f};
        float Jp[3][6] = {};
        float Jx[3][3] = {};
        // Jx^T r and Jp^T r in float64: they cancel across a converged
        // landmark's observations
        double bxt[3] = {0.0, 0.0, 0.0}, gpd[6] = {0.0, 0.0, 0.0, 0.0,
                                                    0.0, 0.0};
        float w = 0.f, chi2 = 0.f;
        int k = -1;
        bool slot_ok = false;
        if (live) {
            const int oi = lm * a.O + o;
            k = a.kf_tab[oi];
            slot_ok = a.val[oi] != 0 && k >= 0 && k < a.L;
            const float* T = a.pose + 7 * min(max(k, 0), a.L - 1);
            const double qw = T[0], qx = T[1], qy = T[2], qz = T[3];
            const double R[3][3] = {
                {1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz),
                 2.0 * (qx * qz + qw * qy)},
                {2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz),
                 2.0 * (qy * qz - qw * qx)},
                {2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx),
                 1.0 - 2.0 * (qx * qx + qy * qy)}};
            double pd[3];
            float p[3], Rf[3][3];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                pd[i] = R[i][0] * X0 + R[i][1] * X1 + R[i][2] * X2 + T[4 + i];
                p[i] = (float)pd[i];
#pragma unroll
                for (int j = 0; j < 3; ++j) Rf[i][j] = (float)R[i][j];
            }
            const double izd = 1.0 / fmax(pd[2], 1e-6);
            const double u_hat = fx * pd[0] * izd + cx;
            const double v_hat = fy * pd[1] * izd + cy;
            const float uo = a.uvr[3 * oi], vo = a.uvr[3 * oi + 1],
                        ro = a.uvr[3 * oi + 2];
            const bool has_ur = ro > 0.f;
            const float disp = fmaxf(uo - ro, 1e-3f);
            const float z_meas = has_ur ? bf / disp : 1.0f;
            const float q = 2.5f / fmaxf(z_meas, 0.1f);
            const float w_ur = fminf(q * q, 1.0f);
            const double rd[3] = {
                u_hat - uo, v_hat - vo,
                has_ur ? (u_hat - bf * izd - ro) * (double)w_ur : 0.0};
            r[0] = (float)rd[0];
            r[1] = (float)rd[1];
            r[2] = (float)rd[2];
            chi2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
            {
                // y = Jpp^T r; Jx^T r = R^T y; Jp^T r = [y, p x y]
                const double izd2 = izd * izd;
                const double su = has_ur ? (double)w_ur : 0.0;
                const double y[3] = {
                    fx * izd * rd[0] + fx * izd * su * rd[2], fy * izd * rd[1],
                    -fx * pd[0] * izd2 * rd[0] - fy * pd[1] * izd2 * rd[1]
                        + (-fx * pd[0] + bf) * izd2 * su * rd[2]};
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    bxt[i] = R[0][i] * y[0] + R[1][i] * y[1] + R[2][i] * y[2];
                    gpd[i] = y[i];
                }
                gpd[3] = pd[1] * y[2] - pd[2] * y[1];
                gpd[4] = pd[2] * y[0] - pd[0] * y[2];
                gpd[5] = pd[0] * y[1] - pd[1] * y[0];
            }
            const bool ok = slot_ok && pd[2] > 0.05;
            w = ok ? fminf(a.huber / sqrtf(fmaxf(chi2, 1e-12f)), 1.0f) : 0.f;
            const float iz = (float)izd;
            const float fxf = (float)fx, fyf = (float)fy;
            const float iz2 = iz * iz;
            const float sur = has_ur ? w_ur : 0.f;
            const float Jpp[3][3] = {
                {fxf * iz, 0.f, -fxf * p[0] * iz2},
                {0.f, fyf * iz, -fyf * p[1] * iz2},
                {fxf * iz * sur, 0.f, (-fxf * p[0] + bf) * iz2 * sur}};
            // dp/dxi = [I | -hat(p)]
            const float mh[3][3] = {{0.f, p[2], -p[1]},
                                    {-p[2], 0.f, p[0]},
                                    {p[1], -p[0], 0.f}};
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    Jp[i][j] = Jpp[i][j];
                    float s = 0.f, t = 0.f;
#pragma unroll
                    for (int m = 0; m < 3; ++m) {
                        s += Jpp[i][m] * mh[m][j];
                        t += Jpp[i][m] * Rf[m][j];
                    }
                    Jp[i][3 + j] = s;
                    Jx[i][j] = t;
                }
            }
        }
        // the landmark block's sums over this chunk, added in chunk order
        {
            float part[10];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int j = i; j < 3; ++j) {
                    part[3 * i - i * (i - 1) / 2 + (j - i)] =
                        w * (Jx[0][i] * Jx[0][j] + Jx[1][i] * Jx[1][j]
                             + Jx[2][i] * Jx[2][j]);
                }
                hbx[i] += gram::seg_sum<SEG>((double)w * bxt[i]);
            }
            part[9] = w * chi2;
#pragma unroll
            for (int u = 0; u < 6; ++u) hs[u] += gram::seg_sum<SEG>(part[u]);
            hs[9] += gram::seg_sum<SEG>(part[9]);
        }
        // the observation's W (= P^T), Hpp block and gradient
        float v[gram::NV];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                v[6 * j + i] = w * (Jp[0][i] * Jx[0][j] + Jp[1][i] * Jx[1][j]
                                    + Jp[2][i] * Jx[2][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = i; j < 6; ++j) {
                v[18 + gram::tri6(i, j)] =
                    w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j]
                         + Jp[2][i] * Jp[2][j]);
            }
            v[39 + i] = (float)((double)w * gpd[i]);
        }
        // the chunk's W rows through shared memory, out coalesced
        if (live) {
            float* wr = wst + 18 * sl;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
#pragma unroll
                for (int j = 0; j < 3; ++j) wr[3 * i + j] = v[6 * j + i];
            }
        }
        __syncwarp();
        if (act) {
            const int nlive = min(SEG, a.O - o0);
            float2* dst =
                reinterpret_cast<float2*>(a.W + 18 * ((size_t)lm * a.O + o0));
            const float2* src = reinterpret_cast<const float2*>(wst);
            for (int u = sl; u < 9 * nlive; u += SEG) dst[u] = src[u];
        }
        __syncwarp();
        gram::stage_chunk<SEG>(st, slot_ok, k, v, lane, nq);
    }
    float Hi[3][3], d[3];
    damped_inverse(hs, a.lam, Hi, d);
    const float bx[3] = {(float)hbx[0], (float)hbx[1], (float)hbx[2]};
    if (sl == 0) {
        if (act) {
            for (int i = 0; i < 3; ++i) {
                a.bx[3 * lm + i] = bx[i];
                for (int j = 0; j < 3; ++j) {
                    a.Hinv[9 * lm + 3 * i + j] = Hi[i][j];
                }
            }
        }
        st.hdr[0] = nq;
        st.hdr[1] = __float_as_int(hs[9]);
    }
    float li[6];
    gram::chol_inv3(hs, d[0], d[1], d[2], li);
    gram::stage_b<SEG>(st, nq, li, lane);
    const float hb[3] = {
        Hi[0][0] * bx[0] + Hi[0][1] * bx[1] + Hi[0][2] * bx[2],
        Hi[1][0] * bx[0] + Hi[1][1] * bx[1] + Hi[1][2] * bx[2],
        Hi[2][0] * bx[0] + Hi[2][1] * bx[1] + Hi[2][2] * bx[2]};
    for (int t = sl; t < nq * 6; t += SEG) {
        float* q = st.q + (t / 6) * QS;
        const int i = t % 6;
        q[Q_R + i] = q[Q_P + i] * hb[0] + q[Q_P + 6 + i] * hb[1]
                     + q[Q_P + 12 + i] * hb[2] - q[Q_G + i];
    }
    __syncwarp();
}

// ---------------------------------------------------------------------------
// L <= ~52: a CTA's landmarks into its shared accumulator
// ---------------------------------------------------------------------------

// acc: [S upper-triangle blocks (Lp, 36) | rhs (6L) | cost]; shared memory
// after it: the pair table (Lp), the listed landmarks (room for a CTA of
// one cluster: ceil(n / 8)), the warps' counts (WARPS), the stages
// (stage_warps x 32 / SEG)
template <int SEG>
__global__ void __launch_bounds__(THREADS, 1)
schur_kernel(SchurArgs a, int stage_warps, int Qmax, double* part) {
    extern __shared__ __align__(16) float sm[];
    constexpr int SPW = 32 / SEG;  // stages a warp
    const int L = a.L, Lp = gram::n_pairs(L), dim = 6 * L;
    const int E = 36 * Lp + dim + 1;
    const int G = gridDim.x, mine = (a.n - (int)blockIdx.x + G - 1) / G;
    float* acc = sm;
    int* ptab = reinterpret_cast<int*>(acc + E);
    int* list = ptab + Lp;
    const int cap = (a.n + gram::CLUSTER - 1) / gram::CLUSTER;
    int* wtot = list + cap;
    // the stages 8-byte aligned (their W rows go out as float2)
    int* stage0 = reinterpret_cast<int*>(sm) + ((E + Lp + cap + WARPS + 1) & ~1);
    const int sw = stage_stride(L, Qmax, SEG);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = tid / 36, e = tid % 36, i = e / 6, j = e % 6;
    const int tri = gram::tri6(i, j);
    for (int t = tid; t < E; t += THREADS) acc[t] = 0.0f;
    gram::pair_table(ptab, L);
    const int nlist = gram::own(
        mine, [&](int jj) { return (int)blockIdx.x + jj * G; },
        [&](int lm) { return has_obs(a, lm); },
        [&](int lm) { empty_row(a, lm); }, list, wtot);
    const int slots = stage_warps * SPW;
    for (int base = 0; base < nlist; base += slots) {
        if (warp < stage_warps && base + warp * SPW < nlist) {
            const int s = warp * SPW + lane / SEG;
            schur_landmark<SEG>(
                a, base + s < nlist ? list[base + s] : -1,
                gram::stage_at(stage0 + s * sw, L, Qmax),
                reinterpret_cast<float*>(stage0 + s * sw
                                         + stage_w_off(L, Qmax)),
                lane);
        }
        __syncthreads();
        // the staged landmarks in list order, an entry's sum in a register
        const int nst = min(slots, nlist - base);
        const auto term = [&](const float* ds, const float* dt, bool diag) {
            const float* bs = ds + Q_B;
            const float* bt = dt + Q_B;
            return (diag ? ds[Q_H + tri] : 0.0f)
                   - (bs[i] * bt[j] + bs[6 + i] * bt[6 + j]
                      + bs[12 + i] * bt[12 + j]);
        };
        // four or five pairs a thread (L = 10, 11) in registers
        const int np = (Lp + gram::GROUPS - 1) / gram::GROUPS;
        if (np == 4) {
            gram::add_pairs<4>(acc, ptab, Lp, g, e, stage0, sw, L, Qmax, nst,
                               term);
        } else if (np == 5) {
            gram::add_pairs<5>(acc, ptab, Lp, g, e, stage0, sw, L, Qmax, nst,
                               term);
        } else {
            gram::add_pairs<0>(acc, ptab, Lp, g, e, stage0, sw, L, Qmax, nst,
                               term);
        }
        if (e < 6) {
            for (int s = g; s < L; s += gram::GROUPS) {
                float sum = acc[36 * Lp + 6 * s + e];
                for (int w = 0; w < nst; ++w) {
                    const gram::Stage st =
                        gram::stage_at(stage0 + w * sw, L, Qmax);
                    const int q = st.map[s];
                    if (q >= 0) sum += st.q[q * QS + Q_R + e];
                }
                acc[36 * Lp + 6 * s + e] = sum;
            }
        }
        if (tid == 0) {
            for (int w = 0; w < nst; ++w) {
                acc[E - 1] += __int_as_float(stage0[w * sw + 1]);
            }
        }
        __syncthreads();
    }
    gram::reduce(acc, E, part, g_schur_tickets, [&](int t, double v) {
        if (t < 36 * Lp) {
            const int p = t / 36, ii = (t % 36) / 6, jj = t % 6;
            const int s = ptab[p] >> 16, u = ptab[p] & 0xffff;
            if (s == u && ii > jj) return;
            const int r = 6 * s + ii, c = 6 * u + jj;
            a.S[(size_t)r * dim + c] = (float)v;
            a.S[(size_t)c * dim + r] = (float)v;
        } else if (t < 36 * Lp + dim) {
            a.rhs[t - 36 * Lp] = (float)v;
        } else {
            *a.cost = (float)v;
        }
    });
}

// ---------------------------------------------------------------------------
// larger L: two phases of one cooperative launch
// ---------------------------------------------------------------------------

struct BigScratch {
    float* qd;      // (n, Qmax, BIG_QS) staged entries
    int* qsl;       // (n, Qmax) the slot of each entry, -1 past the last
    unsigned* bm;   // (L, NW) per slot, a bit an observing landmark
    float* costp;   // (G,) the CTAs' costs
};

// Grid-wide barrier (every CTA resident: a cooperative launch); the
// counters return to zero for the next launch.
__device__ void grid_sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen = &g_schur_bar[1];
        const unsigned g0 = *gen;
        __threadfence();
        if (atomicAdd(&g_schur_bar[0], 1u) == gridDim.x - 1) {
            atomicExch(&g_schur_bar[0], 0u);
            __threadfence();
            atomicAdd(&g_schur_bar[1], 1u);
        } else {
            while (*gen == g0) __nanosleep(64);
        }
        __threadfence();
    }
    __syncthreads();
}

// words of one slot's bitmap, and the groups of 32 landmarks a CTA owns
__host__ __device__ __forceinline__ int big_words(int n) {
    return (n + 31) / 32;
}
__host__ __device__ __forceinline__ int big_groups(int n, int G) {
    return (big_words(n) + G - 1) / G;
}

// shared ints: the CTA's bitmap words (L x groups), its listed landmarks
// (32 x groups), the warps' counts, the stages
__host__ __device__ __forceinline__ int big_smem_ints(int n, int L, int Qmax,
                                                      int G, int stages) {
    const int gr = big_groups(n, G);
    return L * gr + 32 * gr + WARPS + 2
           + stages * gram::stage_words(L, Qmax);
}

// the pair phase: ROW_BATCH landmarks a warp stages at a time (a record
// each: its Qmax slots, then its Qmax entries), bitmap words a pass (up to
// 32 ROW_WORDS landmarks listed at once)
constexpr int ROW_BATCH = 4, ROW_WORDS = 128;

__host__ __device__ __forceinline__ int row_record(int Qmax) {
    return Qmax + Qmax * BIG_QS;
}

// shared floats of the pair phase: row_warps private row accumulators
// (36 L + 6 each), the listed landmarks, the warps' staged records
__host__ __device__ __forceinline__ int row_smem_words(int L, int Qmax,
                                                       int row_warps) {
    return row_warps * (36 * L + 6) + 32 * ROW_WORDS + ROW_WORDS / 32
           + row_warps * ROW_BATCH * row_record(Qmax);
}

template <int SEG>
__global__ void __launch_bounds__(THREADS, 1)
schur_big_kernel(SchurArgs a, int Qmax, int stage_warps, int row_warps,
                 BigScratch z) {
    extern __shared__ __align__(16) int smi[];
    constexpr int SPW = 32 / SEG;
    const int L = a.L, dim = 6 * L, G = gridDim.x;
    const int NW = big_words(a.n), gr = big_groups(a.n, G);
    unsigned* sbm = reinterpret_cast<unsigned*>(smi);  // (L, gr)
    int* list = smi + L * gr;
    int* wtot = list + 32 * gr;
    int* stage0 = smi + ((L * gr + 32 * gr + WARPS + 1) & ~1);
    const int sw = stage_stride(L, Qmax, SEG);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int t = tid; t < L * gr; t += THREADS) sbm[t] = 0u;
    // this CTA's landmarks: the groups of 32 blockIdx.x, blockIdx.x + G, ...
    const int mine = 32 * gr;
    const int nlist = gram::own(
        mine,
        [&](int jj) {
            const int lm = 32 * (blockIdx.x + (jj / 32) * G) + jj % 32;
            return lm < a.n ? lm : -1;
        },
        [&](int lm) { return has_obs(a, lm); },
        [&](int lm) { empty_row(a, lm); }, list, wtot);

    // 1. the landmarks' staged terms, bitmaps and entry map
    float ccost = 0.0f;  // thread 0: the CTA's cost, in list order
    const int slots = stage_warps * SPW;
    for (int base = 0; base < nlist; base += slots) {
        if (warp < stage_warps && base + warp * SPW < nlist) {
            const int s = warp * SPW + lane / SEG;
            const int lm = base + s < nlist ? list[base + s] : -1;
            const gram::Stage st = gram::stage_at(stage0 + s * sw, L, Qmax);
            schur_landmark<SEG>(
                a, lm, st,
                reinterpret_cast<float*>(stage0 + s * sw
                                         + stage_w_off(L, Qmax)),
                lane);
            if (lm >= 0) {
                const int nq = st.hdr[0], sl = lane % SEG;
                for (int t = sl; t < nq * BIG_QS; t += SEG) {
                    z.qd[((size_t)lm * Qmax + t / BIG_QS) * BIG_QS
                         + t % BIG_QS] = st.q[(t / BIG_QS) * QS + Q_B
                                              + t % BIG_QS];
                }
                const int word = lm / 32, gi = word / G;
                for (int q = sl; q < Qmax; q += SEG) {
                    const int slot = q < nq ? st.qslot[q] : -1;
                    z.qsl[(size_t)lm * Qmax + q] = slot;
                    if (slot >= 0) {
                        atomicOr(&sbm[slot * gr + gi], 1u << (lm % 32));
                    }
                }
            }
        }
        __syncthreads();
        if (tid == 0) {
            for (int w = 0; w < min(slots, nlist - base); ++w) {
                ccost += __int_as_float(stage0[w * sw + 1]);
            }
        }
        __syncthreads();
    }
    for (int t = tid; t < L * gr; t += THREADS) {
        const int s = t / gr, word = blockIdx.x + (t % gr) * G;
        if (word < NW) z.bm[(size_t)s * NW + word] = sbm[t];
    }
    if (tid == 0) z.costp[blockIdx.x] = ccost;
    grid_sync();
    if (blockIdx.x == 0 && tid == 0) {
        float c = 0.0f;
        for (int k = 0; k < G; ++k) c += __ldcg(&z.costp[k]);
        *a.cost = c;
    }

    // 2. a CTA a slot row s: its landmarks (bitmap row s), listed in order
    // ROW_WORDS words at a time, go to the row_warps warps in turn (warp w:
    // the w-th, (w + row_warps)-th, ... of each list); a warp stages
    // ROW_BATCH of them and adds each one's blocks (s, t >= s), a lane an
    // entry, into its own row accumulator; the accumulators are then
    // summed in warp order and written, S mirrored
    float* racc = reinterpret_cast<float*>(smi);  // (row_warps, 36 L + 6)
    const int RA = 36 * L + 6;
    int* rlist = smi + row_warps * RA;             // (32 ROW_WORDS,)
    int* rcnt = rlist + 32 * ROW_WORDS;  // (ROW_WORDS / 32,) the warps' counts
    const int rec = row_record(Qmax);
    float* rst = reinterpret_cast<float*>(rcnt + ROW_WORDS / 32)
                 + warp * ROW_BATCH * rec;
    const int i0 = lane / 6, j0 = lane % 6;
    const int tri0 = gram::tri6(i0, j0);
    const int tri1 = lane < 4 ? gram::tri6(5, lane + 2) : 0;
    for (int s = blockIdx.x; s < L; s += G) {
        __syncthreads();
        for (int t = tid; t < row_warps * RA; t += THREADS) racc[t] = 0.0f;
        const unsigned* ms = z.bm + (size_t)s * NW;
        for (int w0 = 0; w0 < NW; w0 += ROW_WORDS) {
            // this pass's landmarks, in order: the first ROW_WORDS / 32
            // warps take a word a lane, scan the words' counts and list
            // their bits
            constexpr int SW = ROW_WORDS / 32;
            unsigned x = 0u;
            int c = 0, inc = 0;
            if (warp < SW) {
                const int wd = w0 + tid;
                x = wd < NW ? __ldcg(ms + wd) : 0u;
                c = __popc(x);
                inc = c;
#pragma unroll
                for (int off = 1; off < 32; off <<= 1) {
                    const int y = __shfl_up_sync(FULL, inc, off);
                    if (lane >= off) inc += y;
                }
                if (lane == 31) rcnt[warp] = inc;
            }
            __syncthreads();
            int nl = 0;
            for (int w = 0; w < SW; ++w) nl += rcnt[w];
            if (warp < SW) {
                int pos = inc - c;
                for (int w = 0; w < warp; ++w) pos += rcnt[w];
                while (x) {
                    rlist[pos++] = 32 * (w0 + tid) + __ffs(x) - 1;
                    x &= x - 1;
                }
            }
            __syncthreads();
            if (warp < row_warps) {
                float* acc = racc + warp * RA;
                for (int b0 = warp * ROW_BATCH; b0 < nl;
                     b0 += row_warps * ROW_BATCH) {
                    const int nb = min(ROW_BATCH, nl - b0);
                    // stage the batch (each landmark's slots and entries)
                    // with asynchronous copies, all in flight at once
                    for (int k = 0; k < nb; ++k) {
                        const int lm = rlist[b0 + k];
                        for (int f = lane; f < rec; f += 32) {
                            const void* src =
                                f < Qmax
                                    ? (const void*)(z.qsl + (size_t)lm * Qmax
                                                    + f)
                                    : (const void*)(z.qd
                                                    + (size_t)lm * Qmax * BIG_QS
                                                    + f - Qmax);
                            __pipeline_memcpy_async(rst + k * rec + f, src, 4);
                        }
                    }
                    __pipeline_commit();
                    __pipeline_wait_prior(0);
                    __syncwarp();
                    for (int k = 0; k < nb; ++k) {
                        const float* r = rst + k * rec;
                        const float* ent = r + Qmax;
                        int qs = 0;
                        for (int q = 0; q < Qmax; ++q) {
                            if (__float_as_int(r[q]) == s) qs = q;
                        }
                        const float* bs = ent + qs * BIG_QS;
                        for (int q = 0; q < Qmax; ++q) {
                            const int t = __float_as_int(r[q]);
                            if (t < s) continue;  // -1 past the last too
                            const float* bt = ent + q * BIG_QS;
                            const bool diag = t == s;
                            float* at = acc + 36 * t;
                            at[lane] += (diag ? bs[18 + tri0] : 0.0f)
                                        - (bs[i0] * bt[j0]
                                           + bs[6 + i0] * bt[6 + j0]
                                           + bs[12 + i0] * bt[12 + j0]);
                            if (lane < 4) {
                                at[32 + lane] +=
                                    (diag ? bs[18 + tri1] : 0.0f)
                                    - (bs[5] * bt[lane + 2]
                                       + bs[11] * bt[lane + 8]
                                       + bs[17] * bt[lane + 14]);
                            }
                        }
                        if (lane < 6) acc[36 * L + lane] += bs[39 + lane];
                    }
                    __syncwarp();
                }
            }
            __syncthreads();
        }
        // the warps' row accumulators, summed in warp order
        for (int u = 36 * s + tid; u < RA; u += THREADS) {
            float v = 0.0f;
            for (int w = 0; w < row_warps; ++w) v += racc[w * RA + u];
            if (u < 36 * L) {
                const int t = u / 36, ii = (u % 36) / 6, jj = u % 6;
                a.S[(size_t)(6 * s + ii) * dim + 6 * t + jj] = v;
                a.S[(size_t)(6 * t + jj) * dim + 6 * s + ii] = v;
            } else {
                a.rhs[6 * s + u - 36 * L] = v;
            }
        }
    }
}

__global__ void schur_backsub(const float* __restrict__ Hinv,
                              const float* __restrict__ bx,
                              const float* __restrict__ W,
                              const int* __restrict__ kf_tab,
                              const uint8_t* __restrict__ val,
                              const float* __restrict__ dx6, int n, int O,
                              int L, float* __restrict__ dxe) {
    const int lm = blockIdx.x * blockDim.x + threadIdx.x;
    if (lm >= n) return;
    float y[3] = {bx[3 * lm], bx[3 * lm + 1], bx[3 * lm + 2]};
    for (int a = 0; a < O; ++a) {
        const int o = lm * O + a;
        const int k = kf_tab[o];
        if (!(val[o] != 0 && k >= 0 && k < L)) continue;
        const float* Wo = W + 18 * o;
        const float* d = dx6 + 6 * k;
        for (int r = 0; r < 6; ++r) {
            y[0] += Wo[3 * r] * d[r];
            y[1] += Wo[3 * r + 1] * d[r];
            y[2] += Wo[3 * r + 2] * d[r];
        }
    }
    const float* Hi = Hinv + 9 * lm;
    for (int i = 0; i < 3; ++i) {
        const float v = -(Hi[3 * i] * y[0] + Hi[3 * i + 1] * y[1] +
                          Hi[3 * i + 2] * y[2]);
        dxe[3 * lm + i] = isfinite(v) ? v : 0.0f;
    }
}

int sm_count() {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

int smem_limit() {
    int dev = 0, lim = 232448;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    return lim;
}

template <int SEG>
int resident_clusters(size_t smem) {
    static size_t cached_smem = 0;
    static int cached = 0;
    if (cached_smem != smem) {
        cached = gram::max_clusters(schur_kernel<SEG>, smem);
        cached_smem = smem;
    }
    return cached;
}

// The launch plan: the shared-accumulator kernel while its shared memory
// fits at least 4 staging warps, else the cooperative kernel on one CTA an
// SM.
struct Plan {
    bool big;
    int seg, Qmax, stage_warps, clusters, G, row_warps;
    size_t smem, scratch;
};

Plan make_plan(int n, int O, int L) {
    Plan p = {};
    p.seg = gram::seg_for(O);
    p.Qmax = max(1, min(O, L));
    const int Lp = gram::n_pairs(L), spw = 32 / p.seg;
    const long long stage = 4LL * spw * stage_stride(L, p.Qmax, p.seg);
    const long long lim = smem_limit();
    const long long fixed =
        4LL * (36LL * Lp + 6 * L + 1 + Lp
               + (n + gram::CLUSTER - 1) / gram::CLUSTER + WARPS + 2);
    const long long w = (lim - fixed) / stage;
    p.stage_warps = lim <= fixed ? 0 : w >= WARPS ? WARPS : (int)w;
    if (p.stage_warps >= 4) {
        p.smem = (size_t)(fixed + stage * p.stage_warps);
        const int need = max(
            1, min(gram::MAX_CLUSTERS,
                   (n + gram::CLUSTER * 2 * spw * WARPS - 1)
                       / (gram::CLUSTER * 2 * spw * WARPS)));
        const int fit = p.seg == 8    ? resident_clusters<8>(p.smem)
                        : p.seg == 16 ? resident_clusters<16>(p.smem)
                                      : resident_clusters<32>(p.smem);
        p.clusters = min(need, fit);
        p.scratch = sizeof(double) * (size_t)p.clusters * (36 * Lp + 6 * L + 1);
        return p;
    }
    p.big = true;
    p.G = sm_count();
    const long long bfixed = 4LL * big_smem_ints(n, L, p.Qmax, p.G, 0);
    const long long bw = (lim - bfixed) / stage;
    p.stage_warps = lim <= bfixed ? 0 : bw >= WARPS ? WARPS : (int)bw;
    // the pair phase reuses the shared memory: as many row accumulators as
    // fit, at most 8
    p.row_warps = 0;
    for (int r = 8; r >= 1 && p.row_warps == 0; --r) {
        if (4LL * row_smem_words(L, p.Qmax, r) <= lim) p.row_warps = r;
    }
    if (p.row_warps == 0) p.stage_warps = 0;
    const long long s1 = bfixed + stage * p.stage_warps;
    const long long s2 = 4LL * row_smem_words(L, p.Qmax, p.row_warps);
    p.smem = (size_t)(s1 > s2 ? s1 : s2);
    p.scratch = 4 * (size_t)n * p.Qmax * (BIG_QS + 1)
                + 4 * ((size_t)L * big_words(n) + p.G) + 64;
    return p;
}

template <int SEG>
cudaError_t launch_big(const Plan& p, SchurArgs a, void* scratch,
                       cudaStream_t stream) {
    auto kernel = schur_big_kernel<SEG>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                        p.smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    const int n = a.n, L = a.L;
    BigScratch z;
    z.qd = static_cast<float*>(scratch);
    z.qsl = reinterpret_cast<int*>(z.qd + (size_t)n * p.Qmax * BIG_QS);
    z.bm = reinterpret_cast<unsigned*>(z.qsl + (size_t)n * p.Qmax);
    z.costp = reinterpret_cast<float*>(z.bm + (size_t)L * big_words(n));
    int Qmax = p.Qmax, sw = p.stage_warps, rw = p.row_warps;
    void* args[] = {&a, &Qmax, &sw, &rw, &z};
    err = cudaLaunchCooperativeKernel((void*)kernel, dim3(p.G), dim3(THREADS),
                                      args, p.smem, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch vsg_schur_reduce needs for (n, O, L).
VSG_API long long vsg_schur_scratch_bytes(int n, int O, int L) {
    return (long long)make_plan(n, O, L).scratch;
}

// pose (L, 7) f32 T_cw, pts (n, 3) f32, kf_tab (n, O) i32 window rows
// (-1 none), uvr (n, O, 3) f32, val (n, O) u8, cam_K (4,) f32, bf () f32
// on the device.  Outputs, every element written: S (6L, 6L), rhs (6L,),
// Hinv (n, 3, 3), bx (n, 3), W (n, O, 6, 3), cost ().  Scratch: the
// vsg_schur_scratch_bytes bytes at ``scratch``, not initialised.
VSG_API int vsg_schur_reduce(const float* pose, const float* pts,
                             const int* kf_tab, const float* uvr,
                             const uint8_t* val, const float* cam_K,
                             const float* bf, int n, int O, int L, float lam,
                             float huber, float* S, float* rhs, float* Hinv,
                             float* bx, float* W, float* cost, void* scratch,
                             cudaStream_t stream) {
    if (L < 1 || O < 1 || n < 0 || L > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    const Plan p = make_plan(n, O, L);
    if (p.stage_warps < 1) return (int)cudaErrorInvalidValue;
    SchurArgs a = {pose, pts, kf_tab, uvr, val, cam_K, bf, n, O, L,
                   lam, huber, S, rhs, Hinv, bx, W, cost};
    double* part = static_cast<double*>(scratch);
    cudaError_t err;
    if (!p.big) {
        err = p.seg == 8 ? gram::launch(schur_kernel<8>, p.clusters, p.smem,
                                        stream, a, p.stage_warps, p.Qmax, part)
              : p.seg == 16
                  ? gram::launch(schur_kernel<16>, p.clusters, p.smem, stream,
                                 a, p.stage_warps, p.Qmax, part)
                  : gram::launch(schur_kernel<32>, p.clusters, p.smem, stream,
                                 a, p.stage_warps, p.Qmax, part);
        return (int)err;
    }
    err = p.seg == 8    ? launch_big<8>(p, a, scratch, stream)
          : p.seg == 16 ? launch_big<16>(p, a, scratch, stream)
                        : launch_big<32>(p, a, scratch, stream);
    return (int)err;
}

// Hinv (n, 3, 3), bx (n, 3), W (n, O, 6, 3), kf_tab (n, O) i32, val (n, O)
// u8, dx6 (L, 6) the solved camera steps.  Output dxe (n, 3) (non-finite
// -> 0).
VSG_API int vsg_schur_backsub(const float* Hinv, const float* bx,
                              const float* W, const int* kf_tab,
                              const uint8_t* val, const float* dx6, int n,
                              int O, int L, float* dxe, cudaStream_t stream) {
    if (n == 0) return 0;
    schur_backsub<<<(n + 127) / 128, 128, 0, stream>>>(Hinv, bx, W, kf_tab,
                                                       val, dx6, n, O, L, dxe);
    return (int)cudaGetLastError();
}
