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
// What bounds it here: latency and atomics.  A call reads ~0.6 MB of rows
// and points and does ~30 MFLOP, mostly the pair sums.
//
// Design (K8's warp-per-landmark reduction is the model): the linearise
// kernel takes a row a thread, adds the landmark's Hxx, bx and P_s with
// float32 atomics (a few rows each) and the slot's 6x6 block and gradient
// (summed over the warp by shuffles: rows are slot-major) into the block's
// shared memory, flushed once a block into the float64 H, g; the reduce
// kernel takes a landmark a warp: its 3x3 factor in every lane, B_s of
// each observing slot (a bit a slot in the landmark's mask words) into
// shared memory, then the lanes split the (slot a, slot b, 6 x 6) products
// and add them to a block-wide shared accumulator of (6L)^2 pair sums,
// flushed once a block with float64 atomics.  Any window size runs: past
// SHARED_ACC_LIMIT (L > 33) the products go straight to the float64 pair
// sums in global memory with an atomic each, as K8's global-BA path does.
// Float32 like the engine's rows (the landmark blocks span ~8 orders of
// magnitude, as K8's: no TF32); the sums the atomics make are in another
// order than the twin's, so S and rhs are held against the float64 twin at
// a tolerance relative to their largest entries.  The back-substitution
// takes a landmark a thread, the cost a row a thread with a float64 block
// sum.
#include "lie.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 27;  // 21 upper-triangular 6x6 entries + 6 gradient
// the reduce kernel's shared pair-sum accumulator up to this many bytes,
// else float64 atomics into the global pair sums
constexpr size_t SHARED_ACC_LIMIT = 160 * 1024;

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

__global__ void __launch_bounds__(THREADS)
linearize_kernel(Rows a, int D, float* __restrict__ Hxx,
                 float* __restrict__ P, unsigned* __restrict__ mask,
                 double* __restrict__ H, double* __restrict__ g) {
    extern __shared__ float acc[];  // (L, NACC)
    for (int t = threadIdx.x; t < a.L * NACC; t += THREADS) acc[t] = 0.0f;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    // whole warps step together (rows are slot-major: a warp's rows
    // nearly always share a slot, so its pose block is summed by shuffles)
    for (int m0 = blockIdx.x * THREADS + (threadIdx.x & ~31); m0 < a.M;
         m0 += gridDim.x * THREADS) {
        const int m = m0 + lane;
        const bool on = m < a.M && a.use[m] != 0;
        const int s = on ? a.slot[m] : -1;
        float Jp[3][6] = {}, r[3] = {0.0f, 0.0f, 0.0f};
        float w = 0.0f;
        if (on) {
            const int n = a.pt[m];
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
            float Jx[3][3];
            for (int k = 0; k < 3; ++k) {
                for (int j = 0; j < 3; ++j) {
                    Jp[k][j] = Jr[k][j];
                    Jp[k][3 + j] = Jr[k][0] * mh[0][j] + Jr[k][1] * mh[1][j] +
                                   Jr[k][2] * mh[2][j];
                    Jx[k][j] = Jr[k][0] * R[j] + Jr[k][1] * R[3 + j] +
                               Jr[k][2] * R[6 + j];
                }
            }
            // the landmark's Hxx (upper 6) and bx, its block P_s
            float* h = Hxx + 9 * n;
            int t = 0;
            for (int i = 0; i < 3; ++i) {
                for (int j = i; j < 3; ++j) {
                    const float v = Jx[0][i] * Jx[0][j] + Jx[1][i] * Jx[1][j] +
                                    Jx[2][i] * Jx[2][j];
                    atomicAdd(&h[t++], w * v);
                }
                const float v =
                    Jx[0][i] * r[0] + Jx[1][i] * r[1] + Jx[2][i] * r[2];
                atomicAdd(&h[6 + i], w * v);
            }
            float* Ps = P + 18 * ((size_t)n * a.L + s);
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 6; ++j) {
                    const float v = Jx[0][i] * Jp[0][j] +
                                    Jx[1][i] * Jp[1][j] + Jx[2][i] * Jp[2][j];
                    atomicAdd(&Ps[6 * i + j], w * v);
                }
            }
            atomicOr(&mask[(size_t)n * mask_words(a.L) + s / 32],
                     1u << (s % 32));
        }
        // the slot's pose block and gradient: a warp sum when the warp's
        // rows share one slot, else an atomic a row
        const int s0 = __shfl_sync(0xffffffffu, s, 0);
        const bool one = __all_sync(0xffffffffu, !on || s == s0) && s0 >= 0;
        float* as = acc + NACC * (one ? s0 : max(s, 0));
        int t = 0;
        for (int i = 0; i < 6; ++i) {
            for (int j = i; j < 6; ++j, ++t) {
                float v = w * (Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j] +
                               Jp[2][i] * Jp[2][j]);
                if (one) {
                    v = vsg_warp_sum(v);
                    if (lane == 0 && v != 0.0f) atomicAdd(&as[t], v);
                } else if (on && v != 0.0f) {
                    atomicAdd(&as[t], v);
                }
            }
            float v = w * (Jp[0][i] * r[0] + Jp[1][i] * r[1] + Jp[2][i] * r[2]);
            if (one) {
                v = vsg_warp_sum(v);
                if (lane == 0) atomicAdd(&as[21 + i], v);
            } else if (on) {
                atomicAdd(&as[21 + i], v);
            }
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < a.L * NACC; t += THREADS) {
        const float v = acc[t];
        if (v == 0.0f) continue;
        const int s = t / NACC, e = t % NACC;
        if (e >= 21) {
            atomicAdd(&g[6 * s + e - 21], (double)v);
            continue;
        }
        int i = 0, rem = e;
        while (rem >= 6 - i) {
            rem -= 6 - i;
            ++i;
        }
        const int j = i + rem;
        atomicAdd(&H[(size_t)(6 * s + i) * D + 6 * s + j], (double)v);
        if (i != j) atomicAdd(&H[(size_t)(6 * s + j) * D + 6 * s + i], (double)v);
    }
}

__global__ void __launch_bounds__(THREADS)
reduce_kernel(int N, int L, const float* __restrict__ Hxx,
              const float* __restrict__ P,
              const unsigned* __restrict__ mask,
              const float* __restrict__ lam_ptr, float eps,
              float* __restrict__ Linv_out, float* __restrict__ c_out,
              double* __restrict__ pairs, double* __restrict__ rhs,
              int shared_acc) {
    extern __shared__ float sh[];
    const int P6 = 6 * L, MW = mask_words(L);
    const int nacc = shared_acc ? P6 * P6 + P6 : 0;
    float* sp = sh;                   // (P6, P6) pair sums (shared_acc)
    float* sr = sp + P6 * P6;         // (P6,) their rhs (shared_acc)
    float* sB = sh + nacc;            // (WARPS, L, 18) B_s
    int* sl = reinterpret_cast<int*>(sB + WARPS * L * 18);
    for (int t = threadIdx.x; t < nacc; t += THREADS) sp[t] = 0.0f;
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* B = sB + warp * L * 18;
    int* slots = sl + warp * L;
    const float lam = lam_ptr[0];
    for (int n = blockIdx.x * WARPS + warp; n < N; n += gridDim.x * WARPS) {
        const float* h = Hxx + 9 * n;
        // damped Hxx (the engine's lam clamp(diag, 1e-6) + eps), Cholesky
        const float a00 = h[0] + (lam * fmaxf(h[0], 1e-6f) + eps);
        const float a11 = h[3] + (lam * fmaxf(h[3], 1e-6f) + eps);
        const float a22 = h[5] + (lam * fmaxf(h[5], 1e-6f) + eps);
        const float l00 = sqrtf(a00);
        const float l10 = h[1] / l00, l20 = h[2] / l00;
        const float l11 = sqrtf(a11 - l10 * l10);
        const float l21 = (h[4] - l20 * l10) / l11;
        const float l22 = sqrtf(a22 - l20 * l20 - l21 * l21);
        const float i00 = 1.0f / l00, i11 = 1.0f / l11, i22 = 1.0f / l22;
        const float i10 = -l10 * i00 * i11;
        const float i21 = -l21 * i11 * i22;
        const float i20 = -(l20 * i00 + l21 * i10) * i22;
        const float b0 = h[6], b1 = h[7], b2 = h[8];
        const float c[3] = {i00 * b0, i10 * b0 + i11 * b1,
                            i20 * b0 + i21 * b1 + i22 * b2};
        if (lane == 0) {
            float* li = Linv_out + 6 * n;
            li[0] = i00;
            li[1] = i10;
            li[2] = i11;
            li[3] = i20;
            li[4] = i21;
            li[5] = i22;
            for (int k = 0; k < 3; ++k) c_out[3 * n + k] = c[k];
        }
        const unsigned* mk = mask + (size_t)n * MW;
        int np = 0;
        for (int s = 0; s < L; ++s) {  // every lane, same value
            if ((mk[s / 32] >> (s % 32)) & 1u) slots[np++] = s;
        }
        __syncwarp();
        // B_s = L^-1 P_s
        for (int t = lane; t < np * 18; t += 32) {
            const int q = t / 18, e = t % 18, rr = e / 6, j = e % 6;
            const float* Ps = P + 18 * ((size_t)n * L + slots[q]);
            float v;
            if (rr == 0) {
                v = i00 * Ps[j];
            } else if (rr == 1) {
                v = i10 * Ps[j] + i11 * Ps[6 + j];
            } else {
                v = i20 * Ps[j] + i21 * Ps[6 + j] + i22 * Ps[12 + j];
            }
            B[18 * q + e] = v;
        }
        __syncwarp();
        for (int t = lane; t < np * np * 36; t += 32) {
            const int qa = t / (np * 36), rem = t % (np * 36);
            const int qb = rem / 36, i = (rem % 36) / 6, j = rem % 6;
            const float* Ba = B + 18 * qa;
            const float* Bb = B + 18 * qb;
            const float v = Ba[i] * Bb[j] + Ba[6 + i] * Bb[6 + j] +
                            Ba[12 + i] * Bb[12 + j];
            if (v != 0.0f) {
                const int e = (6 * slots[qa] + i) * P6 + 6 * slots[qb] + j;
                if (shared_acc) {
                    atomicAdd(&sp[e], v);
                } else {
                    atomicAdd(&pairs[e], (double)v);
                }
            }
        }
        for (int t = lane; t < np * 6; t += 32) {
            const float* Ba = B + 18 * (t / 6);
            const int i = t % 6;
            const float v = Ba[i] * c[0] + Ba[6 + i] * c[1] + Ba[12 + i] * c[2];
            if (v == 0.0f) continue;
            if (shared_acc) {
                atomicAdd(&sr[6 * slots[t / 6] + i], v);
            } else {
                atomicAdd(&rhs[6 * slots[t / 6] + i], (double)v);
            }
        }
        __syncwarp();
    }
    if (!shared_acc) return;
    __syncthreads();
    for (int t = threadIdx.x; t < P6 * P6; t += THREADS) {
        if (sp[t] != 0.0f) atomicAdd(&pairs[t], (double)sp[t]);
    }
    for (int t = threadIdx.x; t < P6; t += THREADS) {
        if (sr[t] != 0.0f) atomicAdd(&rhs[t], (double)sr[t]);
    }
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

}  // namespace

// pose (L, 7) f32 T_cw, pts (N, 3) f32, rows slot / pt (M,) i32,
// uvr (M, 3) f32, use / stereo (M,) u8, cam (4,), bf () f32, the Huber
// widths; lam () f32 on the device, eps.  Outputs: H (D, D) and g (D,)
// f64 (zeroed here, then the undamped pose-diagonal blocks), pairs (6L,
// 6L) and rhs (6L,) f64; per landmark Linv (N, 6) (packed lower inverse
// factor of the damped Hxx), c (N, 3), P (N, L, 3, 6), mask (N, (L + 31) /
// 32) u32 (a bit an observing slot), and
// scratch Hxx (N, 9) f32: Hxx's upper 6 entries and bx (zeroed here where
// accumulated).
VSG_API int vsg_lm_reproj_reduce(
    const float* pose, int L, const float* pts, int N, const int* slot,
    const int* pt, const float* uvr, const uint8_t* use,
    const uint8_t* stereo, int M, const float* cam, const float* bf,
    float huber_mono, float huber_stereo, const float* lam, float eps, int D,
    double* H, double* g, double* pairs, double* rhs, float* Hxx, float* P,
    unsigned* mask, float* Linv, float* c, cudaStream_t stream) {
    if (L < 1) return (int)cudaErrorInvalidValue;
    const int P6 = 6 * L;
    struct {
        void* p;
        size_t n;
    } zero[] = {{H, sizeof(double) * (size_t)D * D},
                {g, sizeof(double) * D},
                {pairs, sizeof(double) * P6 * P6},
                {rhs, sizeof(double) * P6},
                {Hxx, sizeof(float) * 9 * (size_t)N},
                {P, sizeof(float) * 18 * (size_t)N * L},
                {mask, sizeof(unsigned) * (size_t)N * mask_words(L)}};
    for (const auto& z : zero) {
        const cudaError_t err = cudaMemsetAsync(z.p, 0, z.n, stream);
        if (err != cudaSuccess) return (int)err;
    }
    const Rows a = make_rows(pose, L, pts, N, slot, pt, uvr, use, stereo, M,
                             cam, bf, huber_mono, huber_stereo);
    const int sms = sm_count();
    if (M > 0) {
        const size_t shmem = sizeof(float) * L * NACC;
        cudaError_t err = cudaFuncSetAttribute(
            linearize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shmem);
        if (err != cudaSuccess) return (int)err;
        const int blocks = min((M + THREADS - 1) / THREADS, 2 * sms);
        linearize_kernel<<<blocks, THREADS, shmem, stream>>>(a, D, Hxx, P,
                                                             mask, H, g);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (N > 0) {
        const size_t acc = sizeof(float) * ((size_t)P6 * P6 + P6);
        const int shared_acc = acc <= SHARED_ACC_LIMIT;
        const size_t shmem = (shared_acc ? acc : 0) +
                             (sizeof(float) * 18 + sizeof(int)) * WARPS * L;
        const cudaError_t err = cudaFuncSetAttribute(
            reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shmem);
        if (err != cudaSuccess) return (int)err;
        const int blocks = min((N + 8 * WARPS - 1) / (8 * WARPS), sms);
        reduce_kernel<<<blocks, THREADS, shmem, stream>>>(
            N, L, Hxx, P, mask, lam, eps, Linv, c, pairs, rhs, shared_acc);
    }
    return (int)cudaGetLastError();
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
