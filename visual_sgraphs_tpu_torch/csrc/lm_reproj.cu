// K22a: the reprojection rows of the LM engine and their landmark Schur
// reduction; the landmarks' back-substitution and the rows' cost.
//
// Replaces, on the card, the reprojection half of
// visual_sgraphs_tpu/optim/solve.py:85::_assemble and the landmark half of
// :158::_solve_step for the windows of inertial/vi_ba.py:137-164 and
// slam/mapping.py:446-483 (reproj_mono / reproj_stereo rows, Huber
// sqrt(5.991) / sqrt(7.815), points eliminated), and the back-substitution
// dx_pt = -Hxx^-1 (bx + P dx) with the cost of :61::_huber_cost /
// :69::problem_cost at the candidate.
//
// Per row (one per window slot and keypoint, M = 10,000 in the VI BA,
// 11,000 in the local BA): the residual of the pinhole projection (the
// |z| < 1e-9 floor and the stereo column's max(z, 1e-6), both with zero
// derivative past the floor), its analytic Jacobians in the left
// perturbation exp(xi) T of se3_boxplus, d p / d xi = [I | -hat(p)], and
// d p / d X = R, and the engine's IRLS weight w = use * min(1, delta /
// sqrt(chi2)) on both g and H.  Per landmark (N <= 4096 / 8192): Hxx =
// sum w Jx^T Jx, bx = sum w Jx^T r and, per window slot, P_s = sum w Jx^T
// Jp; Hxx damped by lam clamp(diag, 1e-6) + eps as _solve_step does, its
// Cholesky factor L, B_s = L^-1 P_s, c = L^-1 bx, and the pair sums
// sum B_a^T B_b and sum B_a^T c over the slots that observe it.  The
// outputs are kept apart: the undamped pose-diagonal blocks of H and g
// (K22c damps H + the inertial rows before it subtracts the pair sums, so
// K8's damped-after-reduction system is not this function).  Duplicate
// observations of a landmark in one slot each add a row, as the engine's
// scatter does; padding landmarks have no row and stay inert (Hxx = 0,
// damped to eps).
//
// What bounds it here: latency.  A call reads ~0.6 MB of rows and points,
// writes ~0.5 MB and does ~30 MFLOP, mostly the pair sums: microseconds of
// the card.  The previous design took nine device operations (seven
// memsets, P's alone ~3 MB, then a row-major linearisation scattering into
// the landmarks with float atomics and a reduction flushing float64
// atomics), and its sums changed from run to run.
//
// Design: a per-landmark row index (``vsg_lm_reproj_plan``: the used rows
// of each landmark in row order, CSR, one launch of one CTA, built once a
// solve: the rows do not change across its iterations), then one launch a
// call, no memset and no atomics, sums in an order fixed by the data
// (gram.cuh): landmarks without a row get their outputs from one thread;
// a segment of 16 lanes (32 past 16 slots) linearises one landmark's
// rows, a row a lane, sums Hxx and bx by shuffles, collapses the rows of
// one slot into P_s, the slot's undamped 6 x 6 block and gradient,
// factors the damped Hxx and stages B_s = L^-1 P_s and B_s^T c; the CTA's
// 576 threads own the entries of the upper-triangle slot-pair blocks, the
// pair sums' rhs and the pose-diagonal blocks and gradient, and add the
// staged landmarks in landmark order (so H's blocks are summed
// landmark-major, not row by row); clusters of 8 CTAs reduce the partials
// through distributed shared memory and the last cluster to finish a
// slice writes it in float64.
// Every output element is written (H and g zero outside the pose-diagonal
// blocks; P only at the slots set in a landmark's mask, which is all the
// back-substitution reads).  Float32 like the engine's rows (the landmark
// blocks span ~8 orders of magnitude, as K8's: no TF32); the cross-CTA
// sums in float64.  The CTA's accumulator holds (6L)^2 / 2 + 96 L floats
// in shared memory: windows up to L = 47 (K22a raises past it).  The
// back-substitution takes a landmark a thread, the cost a row a thread
// with a float64 block sum.
#include "gram.cuh"
#include "lie.cuh"

namespace {

using gram::FULL;
using gram::Q_B;
using gram::Q_G;
using gram::Q_H;
using gram::Q_P;
using gram::Q_R;
using gram::QS;

constexpr int THREADS = 256;  // back-substitution and cost kernels
constexpr int WARPS = THREADS / 32;
constexpr int PLAN_THREADS = 1024;

__device__ unsigned g_lm_tickets[gram::CLUSTER];

__host__ __device__ __forceinline__ int mask_words(int L) {
    return (L + 31) / 32;
}

struct Rows {
    const float* pose;  // (L, 7) T_cw
    int L;
    const float* pts;  // (N, 3)
    int N;
    const int* slot;
    const int* pt;
    const float* uvr;  // (M, 3)
    const uint8_t* use;
    const uint8_t* stereo;
    int M;
    const float* cam;
    const float* bf;
    float huber_mono, huber_stereo;
};

// The row's camera point p, residual r (r[2] = 0 on mono rows) and d r /
// d p (row 2 zero on mono rows), at pose T and point X.
__device__ void row_residual(const Rows& a, int m, const float* T,
                             const float* X, float* p, float* r,
                             float (*Jr)[3]) {
    quat_rot(T, X, p);
    for (int k = 0; k < 3; ++k) p[k] += T[4 + k];
    const float fx = a.cam[0], fy = a.cam[1], cx = a.cam[2], cy = a.cam[3];
    const float z = p[2];
    const bool tiny = fabsf(z) < 1e-9f;
    const float iz = 1.0f / (tiny ? 1e-9f : z);
    const float u = fx * p[0] * iz + cx;
    const float v = fy * p[1] * iz + cy;
    const bool st = a.stereo[m] != 0;
    const float bf = a.bf[0];
    const float zc = fmaxf(z, 1e-6f);
    r[0] = u - a.uvr[3 * m];
    r[1] = v - a.uvr[3 * m + 1];
    r[2] = st ? (u - bf / zc) - a.uvr[3 * m + 2] : 0.0f;
    const float dinv = tiny ? 0.0f : iz * iz;
    const float dz_ur = z > 1e-6f ? bf / (zc * zc) : 0.0f;
    Jr[0][0] = fx * iz;
    Jr[0][1] = 0.0f;
    Jr[0][2] = -fx * p[0] * dinv;
    Jr[1][0] = 0.0f;
    Jr[1][1] = fy * iz;
    Jr[1][2] = -fy * p[1] * dinv;
    Jr[2][0] = st ? Jr[0][0] : 0.0f;
    Jr[2][1] = 0.0f;
    Jr[2][2] = st ? Jr[0][2] + dz_ur : 0.0f;
}

__device__ __forceinline__ float huber_cost(float chi2, float d) {
    return chi2 <= d * d ? chi2 : 2.0f * d * sqrtf(fmaxf(chi2, 1e-12f)) - d * d;
}

// The used rows of each landmark, in row order: counts, an exclusive scan
// into ptr, a fill at per-landmark cursors (shared atomics), then each
// landmark's segment sorted ascending (a thread a landmark), so the result
// does not depend on the fill's order.  One CTA; cnt: (N + 1) ints of
// shared memory.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ pt, const uint8_t* __restrict__ use,
            int M, int N, int* __restrict__ ptr, int* __restrict__ idx) {
    extern __shared__ int cnt[];
    __shared__ int wsum[PLAN_THREADS / 32];
    __shared__ int total;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int n = tid; n <= N; n += PLAN_THREADS) cnt[n] = 0;
    __syncthreads();
    for (int m = tid; m < M; m += PLAN_THREADS) {
        const int p = pt[m];
        if (use[m] && p >= 0 && p < N) atomicAdd(&cnt[p], 1);
    }
    __syncthreads();
    const int seg = (N + PLAN_THREADS - 1) / PLAN_THREADS;
    const int b = min(N, tid * seg), e = min(N, b + seg);
    int sum = 0;
    for (int n = b; n < e; ++n) sum += cnt[n];
    int x = sum;
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int v = wsum[lane];
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(FULL, v, off);
            if (lane >= off) v += y;
        }
        wsum[lane] = v;
    }
    __syncthreads();
    int run = x - sum + (warp ? wsum[warp - 1] : 0);
    for (int n = b; n < e; ++n) {
        const int v = cnt[n];
        cnt[n] = run;
        ptr[n] = run;
        run += v;
    }
    if (tid == PLAN_THREADS - 1) {
        total = run;
        ptr[N] = run;
    }
    __syncthreads();
    for (int m = tid; m < M; m += PLAN_THREADS) {
        const int p = pt[m];
        if (use[m] && p >= 0 && p < N) idx[atomicAdd(&cnt[p], 1)] = m;
    }
    for (int t = total + tid; t < M; t += PLAN_THREADS) idx[t] = -1;
    __syncthreads();
    // cnt[n] is now the end of landmark n's segment
    for (int n = tid; n < N; n += PLAN_THREADS) {
        const int lo = n ? cnt[n - 1] : 0, hi = cnt[n];
        for (int i = lo + 1; i < hi; ++i) {
            const int v = idx[i];
            int j = i - 1;
            while (j >= lo && idx[j] > v) {
                idx[j + 1] = idx[j];
                --j;
            }
            idx[j + 1] = v;
        }
    }
}

struct ReduceOut {
    const float* lam;  // () the damping
    float eps;
    int D;
    double* H;      // (D, D)
    double* g;      // (D,)
    double* pairs;  // (6L, 6L)
    double* rhs;    // (6L,)
    float* Linv;    // (N, 6)
    float* c;       // (N, 3)
    float* P;       // (N, L, 3, 6), at the observed slots
    unsigned* mask;  // (N, mask_words(L))
};

// The outputs of a landmark without a row: Hxx = 0 damped, c = 0, no
// observing slot.
__device__ void lm_idle(const ReduceOut& o, int n, int L, float lam) {
    const float hs[6] = {};
    const float d = lam * 1e-6f + o.eps;
    float li[6];
    gram::chol_inv3(hs, d, d, d, li);
    for (int k = 0; k < 6; ++k) o.Linv[6 * n + k] = li[k];
    for (int k = 0; k < 3; ++k) o.c[3 * n + k] = 0.0f;
    for (int w = 0; w < mask_words(L); ++w) {
        o.mask[(size_t)n * mask_words(L) + w] = 0u;
    }
}

// One listed landmark's rows (rows[ptr[n] .. ptr[n + 1]) of the plan; n <
// 0: none) by one segment of SEG lanes (every lane of the warp calls):
// writes its Linv, c, mask and P and stages its per-slot terms (header:
// entries).
template <int SEG>
__device__ void lm_landmark(const Rows& a, const int* __restrict__ ptr,
                            const int* __restrict__ idx, int n,
                            const ReduceOut& o, float lam, gram::Stage st,
                            int lane) {
    const int L = a.L, sl = lane % SEG;
    gram::stage_reset<SEG>(st, L, lane);
    const int beg = n >= 0 ? ptr[n] : 0, end = n >= 0 ? ptr[n + 1] : 0;
    // chunks of SEG rows, as many as the warp's longest landmark needs
    const int chunks = __reduce_max_sync(FULL, (end - beg + SEG - 1) / SEG);
    float hs[9] = {};  // Hxx (upper 6), bx
    int nq = 0;
    for (int ch = 0; ch < chunks; ++ch) {
        const int r0 = beg + ch * SEG;
        const int m = r0 + sl < end ? idx[r0 + sl] : -1;
        const int s = m >= 0 ? a.slot[m] : -1;
        const bool on = m >= 0 && s >= 0 && s < L;
        float Jp[3][6] = {}, Jx[3][3] = {}, r[3] = {0.0f, 0.0f, 0.0f};
        float w = 0.0f;
        if (on) {
            const float* T = a.pose + 7 * s;
            float p[3], Jr[3][3], R[9];
            row_residual(a, m, T, a.pts + 3 * n, p, r, Jr);
            const float chi2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
            const float delta = a.stereo[m] ? a.huber_stereo : a.huber_mono;
            w = fminf((1.0f / sqrtf(fmaxf(chi2, 1e-12f))) * delta, 1.0f);
            quat_to_mat(T, R);
            // Jp = Jr [I | -hat(p)], Jx = Jr R
            const float mh[3][3] = {{0.0f, p[2], -p[1]},
                                    {-p[2], 0.0f, p[0]},
                                    {p[1], -p[0], 0.0f}};
#pragma unroll
            for (int k = 0; k < 3; ++k) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    Jp[k][j] = Jr[k][j];
                    Jp[k][3 + j] = Jr[k][0] * mh[0][j] + Jr[k][1] * mh[1][j] +
                                   Jr[k][2] * mh[2][j];
                    Jx[k][j] = Jr[k][0] * R[j] + Jr[k][1] * R[3 + j] +
                               Jr[k][2] * R[6 + j];
                }
            }
        }
        {
            float part[9];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int j = i; j < 3; ++j) {
                    part[3 * i - i * (i - 1) / 2 + (j - i)] =
                        w * (Jx[0][i] * Jx[0][j] + Jx[1][i] * Jx[1][j]
                             + Jx[2][i] * Jx[2][j]);
                }
                part[6 + i] = w * (Jx[0][i] * r[0] + Jx[1][i] * r[1]
                                   + Jx[2][i] * r[2]);
            }
#pragma unroll
            for (int u = 0; u < 9; ++u) hs[u] += gram::seg_sum<SEG>(part[u]);
        }
        // the row's P (w Jx^T Jp), pose block (w Jp^T Jp) and gradient
        float v[gram::NV];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 6; ++j) {
                v[6 * i + j] = w * (Jx[0][i] * Jp[0][j] + Jx[1][i] * Jp[1][j]
                                    + Jx[2][i] * Jp[2][j]);
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
            v[39 + i] = w * (Jp[0][i] * r[0] + Jp[1][i] * r[1]
                             + Jp[2][i] * r[2]);
        }
        gram::stage_chunk<SEG>(st, on, s, v, lane, nq);
    }
    // damped Hxx (the engine's lam clamp(diag, 1e-6) + eps), Cholesky
    float li[6];
    gram::chol_inv3(hs, lam * fmaxf(hs[0], 1e-6f) + o.eps,
                    lam * fmaxf(hs[3], 1e-6f) + o.eps,
                    lam * fmaxf(hs[5], 1e-6f) + o.eps, li);
    const float c[3] = {li[0] * hs[6], li[1] * hs[6] + li[2] * hs[7],
                        li[3] * hs[6] + li[4] * hs[7] + li[5] * hs[8]};
    if (sl == 0) {
        if (n >= 0) {
            for (int k = 0; k < 6; ++k) o.Linv[6 * n + k] = li[k];
            for (int k = 0; k < 3; ++k) o.c[3 * n + k] = c[k];
        }
        st.hdr[0] = nq;
    }
    if (n >= 0) {
        const int MW = mask_words(L);
        for (int wd = 0; wd < MW; ++wd) {
            unsigned b = 0u;
            for (int q = 0; q < nq; ++q) {
                const int sq = st.qslot[q];
                if (sq / 32 == wd) b |= 1u << (sq % 32);
            }
            if (sl == 0) o.mask[(size_t)n * MW + wd] = b;
        }
        for (int t = sl; t < nq * 18; t += SEG) {
            const int q = t / 18;
            o.P[((size_t)n * L + st.qslot[q]) * 18 + t % 18] =
                st.q[q * QS + Q_P + t % 18];
        }
    }
    gram::stage_b<SEG>(st, nq, li, lane);
    for (int t = sl; t < nq * 6; t += SEG) {
        float* q = st.q + (t / 6) * QS;
        const int j = t % 6;
        q[Q_R + j] = q[Q_B + j] * c[0] + q[Q_B + 6 + j] * c[1]
                     + q[Q_B + 12 + j] * c[2];
    }
    __syncwarp();
}

// acc: [pairs (Lp, 36) | rhs (6L) | pose blocks (L, 36) | g (6L)]; shared
// memory after it: the pair table (Lp), the listed landmarks (room for a
// CTA of one cluster: ceil(N / 8)), the warps' counts, the stages
// (stage_warps x 32 / SEG)
template <int SEG>
__global__ void __launch_bounds__(gram::THREADS, 1)
reduce_kernel(Rows a, const int* __restrict__ ptr,
              const int* __restrict__ idx, ReduceOut o, int stage_warps,
              double* part) {
    extern __shared__ __align__(16) float sm[];
    constexpr int SPW = 32 / SEG;
    const int L = a.L, N = a.N, Lp = gram::n_pairs(L), P6 = 6 * L;
    const int oR = 36 * Lp, oH = oR + P6, oG = oH + 36 * L, E = oG + P6;
    const int G = gridDim.x, mine = (N - (int)blockIdx.x + G - 1) / G;
    float* acc = sm;
    int* ptab = reinterpret_cast<int*>(acc + E);
    int* list = ptab + Lp;
    int* wtot = list + (N + gram::CLUSTER - 1) / gram::CLUSTER;
    int* stage0 = wtot + gram::WARPS;
    const int sw = gram::stage_words(L, L);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = tid / 36, e = tid % 36, i = e / 6, j = e % 6;
    const int tri = gram::tri6(i, j);
    for (int t = tid; t < E; t += gram::THREADS) acc[t] = 0.0f;
    gram::pair_table(ptab, L);
    // H and g are zero outside the pose-diagonal blocks: a slice a CTA
    const int D = o.D;
    for (size_t t = (size_t)blockIdx.x * gram::THREADS + tid;
         t < (size_t)D * D; t += (size_t)gridDim.x * gram::THREADS) {
        const int r = (int)(t / D), col = (int)(t % D);
        if (r < P6 && col < P6 && r / 6 == col / 6) continue;
        o.H[t] = 0.0;
    }
    for (int t = blockIdx.x * gram::THREADS + tid; t < D - P6;
         t += gridDim.x * gram::THREADS) {
        o.g[P6 + t] = 0.0;
    }
    const float lam = o.lam[0];
    const int nlist = gram::own(
        mine, [&](int jj) { return (int)blockIdx.x + jj * G; },
        [&](int n) { return ptr[n + 1] > ptr[n]; },
        [&](int n) { lm_idle(o, n, L, lam); }, list, wtot);
    const int slots = stage_warps * SPW;
    for (int base = 0; base < nlist; base += slots) {
        if (warp < stage_warps && base + warp * SPW < nlist) {
            const int s = warp * SPW + lane / SEG;
            lm_landmark<SEG>(a, ptr, idx,
                             base + s < nlist ? list[base + s] : -1, o, lam,
                             gram::stage_at(stage0 + s * sw, L, L), lane);
        }
        __syncthreads();
        // the staged landmarks in list order, an entry's sum in a register
        const int nst = min(slots, nlist - base);
        const auto term = [&](const float* ds, const float* dt, bool) {
            const float* bs = ds + Q_B;
            const float* bt = dt + Q_B;
            return bs[i] * bt[j] + bs[6 + i] * bt[6 + j]
                   + bs[12 + i] * bt[12 + j];
        };
        // four or five pairs a thread (L = 10, 11) in registers
        const int np = (Lp + gram::GROUPS - 1) / gram::GROUPS;
        if (np == 4) {
            gram::add_pairs<4>(acc, ptab, Lp, g, e, stage0, sw, L, L, nst,
                               term);
        } else if (np == 5) {
            gram::add_pairs<5>(acc, ptab, Lp, g, e, stage0, sw, L, L, nst,
                               term);
        } else {
            gram::add_pairs<0>(acc, ptab, Lp, g, e, stage0, sw, L, L, nst,
                               term);
        }
        for (int s = g; s < L; s += gram::GROUPS) {
            float h = acc[oH + 36 * s + e];
            float rr = e < 6 ? acc[oR + 6 * s + e] : 0.0f;
            float gg = e < 6 ? acc[oG + 6 * s + e] : 0.0f;
            for (int w = 0; w < nst; ++w) {
                const gram::Stage st = gram::stage_at(stage0 + w * sw, L, L);
                const int q = st.map[s];
                if (q < 0) continue;
                const float* d = st.q + q * QS;
                h += d[Q_H + tri];
                if (e < 6) {
                    rr += d[Q_R + e];
                    gg += d[Q_G + e];
                }
            }
            acc[oH + 36 * s + e] = h;
            if (e < 6) {
                acc[oR + 6 * s + e] = rr;
                acc[oG + 6 * s + e] = gg;
            }
        }
        __syncthreads();
    }
    gram::reduce(acc, E, part, g_lm_tickets, [&](int t, double v) {
        if (t < oR) {
            const int p = t / 36, ii = (t % 36) / 6, jj = t % 6;
            const int s = ptab[p] >> 16, u = ptab[p] & 0xffff;
            if (s == u && ii > jj) return;
            const int r = 6 * s + ii, col = 6 * u + jj;
            o.pairs[(size_t)r * P6 + col] = v;
            o.pairs[(size_t)col * P6 + r] = v;
        } else if (t < oH) {
            o.rhs[t - oR] = v;
        } else if (t < oG) {
            const int s = (t - oH) / 36, ee = (t - oH) % 36;
            o.H[(size_t)(6 * s + ee / 6) * D + 6 * s + ee % 6] = v;
        } else {
            o.g[t - oG] = v;
        }
    });
}

__global__ void __launch_bounds__(THREADS)
backsub_kernel(int N, int L, const float* __restrict__ pts,
               const uint8_t* __restrict__ fixed,
               const float* __restrict__ Linv, const float* __restrict__ c,
               const float* __restrict__ P,
               const unsigned* __restrict__ mask,
               const float* __restrict__ dx, float* __restrict__ out) {
    const int n = blockIdx.x * THREADS + threadIdx.x;
    if (n >= N) return;
    // y = c + L^-1 sum_s P_s dx_s, dx_pt = -L^-T y
    float t[3] = {0.0f, 0.0f, 0.0f};
    const unsigned* mk = mask + (size_t)n * mask_words(L);
    for (int s = 0; s < L; ++s) {
        if (!((mk[s / 32] >> (s % 32)) & 1u)) continue;
        const float* Ps = P + 18 * ((size_t)n * L + s);
        const float* d = dx + 6 * s;
        for (int i = 0; i < 3; ++i) {
            float v = 0.0f;
            for (int j = 0; j < 6; ++j) v += Ps[6 * i + j] * d[j];
            t[i] += v;
        }
    }
    const float* li = Linv + 6 * n;
    const float y0 = c[3 * n] + li[0] * t[0];
    const float y1 = c[3 * n + 1] + li[1] * t[0] + li[2] * t[1];
    const float y2 = c[3 * n + 2] + li[3] * t[0] + li[4] * t[1] + li[5] * t[2];
    const float d[3] = {-(li[0] * y0 + li[1] * y1 + li[3] * y2),
                        -(li[2] * y1 + li[4] * y2), -(li[5] * y2)};
    for (int i = 0; i < 3; ++i) {
        const float v = (fixed[n] || !isfinite(d[i])) ? 0.0f : d[i];
        out[3 * n + i] = pts[3 * n + i] + v;
    }
}

__global__ void __launch_bounds__(THREADS)
cost_kernel(Rows a, double* __restrict__ cost) {
    __shared__ double part[WARPS];
    double acc = 0.0;
    for (int m = blockIdx.x * THREADS + threadIdx.x; m < a.M;
         m += gridDim.x * THREADS) {
        if (!a.use[m]) continue;
        float p[3], r[3], Jr[3][3];
        row_residual(a, m, a.pose + 7 * a.slot[m], a.pts + 3 * a.pt[m], p, r,
                     Jr);
        const float chi2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
        acc += (double)huber_cost(
            chi2, a.stereo[m] ? a.huber_stereo : a.huber_mono);
    }
    for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int w = 0; w < WARPS; ++w) s += part[w];
        atomicAdd(cost, s);
    }
}

Rows make_rows(const float* pose, int L, const float* pts, int N,
               const int* slot, const int* pt, const float* uvr,
               const uint8_t* use, const uint8_t* stereo, int M,
               const float* cam, const float* bf, float hm, float hs) {
    Rows a;
    a.pose = pose;
    a.L = L;
    a.pts = pts;
    a.N = N;
    a.slot = slot;
    a.pt = pt;
    a.uvr = uvr;
    a.use = use;
    a.stereo = stereo;
    a.M = M;
    a.cam = cam;
    a.bf = bf;
    a.huber_mono = hm;
    a.huber_stereo = hs;
    return a;
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
        cached = gram::max_clusters(reduce_kernel<SEG>, smem);
        cached_smem = smem;
    }
    return cached;
}

// The reduction's launch plan: segment width, staging warps (<= 18, 0 when
// even 4 do not fit beside the accumulator), clusters (no more than are
// resident at once), shared bytes, scratch entries.
struct Plan {
    int seg, stage_warps, clusters, E;
    size_t smem;
};

Plan make_plan(int N, int L) {
    Plan p = {};
    const int Lp = gram::n_pairs(L);
    p.seg = L <= 16 ? 16 : 32;
    const int spw = 32 / p.seg;
    p.E = 36 * Lp + 12 * L + 36 * L;
    const long long fixed =
        4LL * (p.E + Lp + (N + gram::CLUSTER - 1) / gram::CLUSTER
               + gram::WARPS);
    const long long stage = 4LL * spw * gram::stage_words(L, L);
    const long long room = (long long)smem_limit() - fixed;
    const long long w = room <= 0 ? 0 : room / stage;
    p.stage_warps = w >= gram::WARPS ? gram::WARPS : w >= 4 ? (int)w : 0;
    if (p.stage_warps == 0) return p;
    p.smem = (size_t)(fixed + stage * p.stage_warps);
    const int per = gram::CLUSTER * 2 * spw * p.stage_warps;
    const int need = max(1, min(gram::MAX_CLUSTERS, (N + per - 1) / per));
    p.clusters = min(need, p.seg == 16 ? resident_clusters<16>(p.smem)
                                       : resident_clusters<32>(p.smem));
    return p;
}

}  // namespace

// Bytes of the float64 scratch vsg_lm_reproj_reduce needs for N landmarks
// and L slots, or -1 when the window is too wide for the kernel.
VSG_API long long vsg_lm_reproj_scratch_bytes(int N, int L) {
    if (L < 1) return -1;
    const Plan p = make_plan(N, L);
    if (p.stage_warps == 0) return -1;
    return (long long)sizeof(double) * p.clusters * p.E;
}

// The plan of rows pt / use (M,) over N landmarks: ptr (N + 1,) i32 and
// idx (M,) i32, the used rows with a landmark id in [0, N) grouped by
// landmark in row order, -1 past ptr[N].
VSG_API int vsg_lm_reproj_plan(const int* pt, const uint8_t* use, int M,
                               int N, int* ptr, int* idx,
                               cudaStream_t stream) {
    const size_t smem = sizeof(int) * ((size_t)N + 1);
    if (N < 0 || (long long)smem > smem_limit()) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaFuncSetAttribute(
        plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    plan_kernel<<<1, PLAN_THREADS, smem, stream>>>(pt, use, M, N, ptr, idx);
    return (int)cudaGetLastError();
}

// pose (L, 7) f32 T_cw, pts (N, 3) f32, rows slot / pt (M,) i32,
// uvr (M, 3) f32, use / stereo (M,) u8, cam (4,), bf () f32, the Huber
// widths; lam () f32 on the device, eps; the plan ptr (N + 1,), idx (M,)
// of vsg_lm_reproj_plan.  Outputs, every element written: H (D, D) and g
// (D,) f64 (the undamped pose-diagonal blocks, zero elsewhere), pairs (6L,
// 6L) and rhs (6L,) f64; per landmark Linv (N, 6) (packed lower inverse
// factor of the damped Hxx), c (N, 3), mask (N, (L + 31) / 32) u32 (a bit
// an observing slot) and P (N, L, 3, 6) at the slots of its mask.
// Scratch: vsg_lm_reproj_scratch_bytes bytes at ``part``, not
// initialised.
VSG_API int vsg_lm_reproj_reduce(
    const float* pose, int L, const float* pts, int N, const int* slot,
    const int* pt, const float* uvr, const uint8_t* use,
    const uint8_t* stereo, int M, const float* cam, const float* bf,
    float huber_mono, float huber_stereo, const float* lam, float eps, int D,
    const int* ptr, const int* idx, double* H, double* g, double* pairs,
    double* rhs, float* P, unsigned* mask, float* Linv, float* c,
    double* part, cudaStream_t stream) {
    if (L < 1 || D < 6 * L) return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(N, L);
    if (p.stage_warps == 0) return (int)cudaErrorInvalidValue;
    const Rows a = make_rows(pose, L, pts, N, slot, pt, uvr, use, stereo, M,
                             cam, bf, huber_mono, huber_stereo);
    ReduceOut o = {lam, eps, D, H, g, pairs, rhs, Linv, c, P, mask};
    return (int)(p.seg == 16
                     ? gram::launch(reduce_kernel<16>, p.clusters, p.smem,
                                    stream, a, ptr, idx, o, p.stage_warps,
                                    part)
                     : gram::launch(reduce_kernel<32>, p.clusters, p.smem,
                                    stream, a, ptr, idx, o, p.stage_warps,
                                    part));
}

// As vsg_lm_reproj_reduce's rows, with fixed (N,) u8.  With a step dx
// (D,) f32 (the pose block first): out (N, 3) = pts + the points' step
// from Linv, c, P, mask (zero where fixed or not finite), and the cost at
// (pose, out); without (dx null): the cost at (pose, pts).  cost () f64
// += the rows' robust cost (zeroed first when ``zero``).
VSG_API int vsg_lm_reproj_cost(
    const float* pose, int L, const float* pts, int N, const int* slot,
    const int* pt, const float* uvr, const uint8_t* use,
    const uint8_t* stereo, int M, const float* cam, const float* bf,
    float huber_mono, float huber_stereo, const uint8_t* fixed,
    const float* Linv, const float* c, const float* P,
    const unsigned* mask,
    const float* dx, float* out, double* cost, int zero,
    cudaStream_t stream) {
    if (zero) {
        const cudaError_t err =
            cudaMemsetAsync(cost, 0, sizeof(double), stream);
        if (err != cudaSuccess) return (int)err;
    }
    const float* at = pts;
    if (dx != nullptr && N > 0) {
        backsub_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            N, L, pts, fixed, Linv, c, P, mask, dx, out);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        at = out;
    }
    const Rows a = make_rows(pose, L, at, N, slot, pt, uvr, use, stereo, M,
                             cam, bf, huber_mono, huber_stereo);
    if (M > 0) {
        const int blocks = min((M + THREADS - 1) / THREADS, 2 * sm_count());
        cost_kernel<<<blocks, THREADS, 0, stream>>>(a, cost);
    }
    return (int)cudaGetLastError();
}
