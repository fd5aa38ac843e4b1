// K22c: the LM step of the engine's dense reduced system, in one block.
//
// Replaces visual_sgraphs_tpu/optim/solve.py:158::_solve_step's dense
// half and the retraction of optim/solve.py:225::_retract_all, as
// optimize (:233-268) runs them for the VI local BA, the windowed local BA
// and the inertial initialisation:
//   S = H + diag(lam clamp(diag H, 1e-6) + eps) - pairs  (pose block),
//   rhs = -g + rhs_pairs,
//   S <- S fm fm^T + diag(1 - fm), rhs <- rhs fm   (the gauge mask),
//   dx = S^-1 rhs by Cholesky, zeroed when not finite or when the
//   factorisation fails, times fm,
// then every reduced family moved by its slice of dx into candidate
// tables: SE(3) by the left boxplus exp(dx) T, velocities and biases by
// addition, the gravity direction by q so3_exp([d, 0]) (renormalised), the
// scale by s exp(d).  H and g come from K22a / K22b, pairs and rhs_pairs
// (the landmarks' Schur terms) from K22a.  The accept / reject and the
// damping update stay on the device, outside (lm_kernels.py).
//
// What bounds it here: latency.  D = 150 (VI BA), 66 (local BA) or 3n + 9
// (initialisation, the fixed poses compacted out): a Cholesky of ~D^3 / 6
// multiply-adds (0.56 M at D = 150) and two triangular solves, each a
// chain of D dependent steps.
//
// Design: the packed lower triangle of S (D (D + 1) / 2 doubles: 90 KB at
// D = 150, 162 KB at D = 201) lives in one block's dynamic shared memory
// (global scratch past 220 KB); a right-looking Cholesky takes one column
// a step (thread 0 the pivot, the block the column, copied to a
// contiguous vector so that the trailing update, on a 16 x 32 thread
// grid, reads it without bank conflicts), the triangular solves in one
// warp's registers, a shuffle a step.
//
// Precision, chosen by measurement: everything is float64.  The reduced
// system spans ~17 orders of magnitude (a gyro bias walk's information is
// ~1 / (3.6e-10 dt) beside O(1) entries), where the reference factorises
// in float32.  On a real window of ``inertial_slice`` (NVIDIA H100 80GB
// HBM3, 700.00 W) the float32 twin's step is 3.4e-6 (VI BA) and 1.2e-6
// (initialisation) of the largest entry off the float64 solve
// (``selfcheck.check_lm_solve`` prints both on every run): small there,
// but a one-block latency-bound kernel pays little for float64, and the
// step no longer depends on how close a window comes to float32's limit.
#include "lie.cuh"

namespace {

constexpr int THREADS = 512;
// the triangular solves keep the rhs in warp 0's registers up to this D;
// the larger systems of the global-scratch path solve in place
constexpr int MAX_SOLVE_D = 256;
constexpr int POSE = 0, VEL = 1, BG = 2, BA = 3, GDIR = 4, SCALE = 5;

struct Fams {
    const float* in[6];
    float* out[6];
    int rows[6];
    int off[6];
};

__host__ __device__ __forceinline__ size_t tri(int i, int j) {
    return (size_t)i * (i + 1) / 2 + j;
}

__global__ void __launch_bounds__(THREADS)
lm_solve_kernel(const double* __restrict__ H, const double* __restrict__ g,
                const double* __restrict__ pairs,
                const double* __restrict__ rhs_pairs, int P6,
                const uint8_t* __restrict__ free_mask, int D,
                const float* __restrict__ lam_ptr, float eps,
                float* __restrict__ dx_out, Fams f, double* scratch) {
    extern __shared__ double sh[];
    __shared__ int ok_sh;
    double* A = scratch != nullptr ? scratch : sh;
    double* b = A + tri(D, 0);
    double* col = b + D;  // column j of L, contiguous (no bank conflicts)
    float* dx = reinterpret_cast<float*>(col + D);
    const int tid = threadIdx.x;
    const double lam = (double)lam_ptr[0];
    // ---- the damped, reduced, masked system (lower triangle)
    for (size_t t = tid; t < tri(D, 0); t += THREADS) {
        int i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
        while (tri(i + 1, 0) <= t) ++i;
        while (tri(i, 0) > t) --i;
        const int j = (int)(t - tri(i, 0));
        double a = H[(size_t)i * D + j];
        if (i == j) a += lam * fmax(a, 1e-6) + (double)eps;
        if (i < P6 && j < P6) a -= pairs[i * P6 + j];
        const double fi = free_mask[i] ? 1.0 : 0.0;
        const double fj = free_mask[j] ? 1.0 : 0.0;
        A[t] = a * fi * fj + (i == j ? 1.0 - fi : 0.0);
    }
    for (int i = tid; i < D; i += THREADS) {
        double r = -g[i];
        if (i < P6) r += rhs_pairs[i];
        b[i] = r * (free_mask[i] ? 1.0 : 0.0);
    }
    if (tid == 0) ok_sh = 1;
    __syncthreads();
    // ---- Cholesky, right-looking, one column a step; the trailing update
    // on a 16 x 32 thread grid (no index division)
    const int ty = tid / 32, tx = tid % 32;
    for (int j = 0; j < D; ++j) {
        if (tid == 0) {
            const double d = A[tri(j, j)];
            if (!(d > 0.0)) ok_sh = 0;
            A[tri(j, j)] = sqrt(d);
        }
        __syncthreads();
        const double djj = A[tri(j, j)];
        for (int i = j + 1 + tid; i < D; i += THREADS) {
            const double l = A[tri(i, j)] / djj;
            A[tri(i, j)] = l;
            col[i] = l;
        }
        __syncthreads();
        for (int i = j + 1 + ty; i < D; i += THREADS / 32) {
            const double lij = col[i];
            double* Ai = A + tri(i, 0);
            for (int k = j + 1 + tx; k <= i; k += 32) Ai[k] -= lij * col[k];
        }
        __syncthreads();
    }
    // ---- L y = b, then L^T x = y (in place in b).  Up to MAX_SOLVE_D by
    // warp 0 alone: lane l keeps b[l], b[l + 32], ... in registers and one
    // shuffle a step broadcasts the solved entry; past it, one row a step
    // with block barriers
    if (D <= MAX_SOLVE_D) {
        if (tid < 32) {
            constexpr int PER = MAX_SOLVE_D / 32;
            double v[PER];
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                const int i = tx + 32 * q;
                v[q] = i < D ? b[i] : 0.0;
            }
            for (int j = 0; j < D; ++j) {
                const int owner = j % 32, qj = j / 32;
                double yj = 0.0;
#pragma unroll
                for (int q = 0; q < PER; ++q) {
                    if (q == qj) {
                        if (tx == owner) v[q] /= A[tri(j, j)];
                        yj = v[q];
                    }
                }
                yj = __shfl_sync(0xffffffffu, yj, owner);
#pragma unroll
                for (int q = 0; q < PER; ++q) {
                    const int i = tx + 32 * q;
                    if (q >= qj && i > j && i < D) v[q] -= A[tri(i, j)] * yj;
                }
            }
            for (int j = D - 1; j >= 0; --j) {
                const int owner = j % 32, qj = j / 32;
                double xj = 0.0;
#pragma unroll
                for (int q = 0; q < PER; ++q) {
                    if (q == qj) {
                        if (tx == owner) v[q] /= A[tri(j, j)];
                        xj = v[q];
                    }
                }
                xj = __shfl_sync(0xffffffffu, xj, owner);
#pragma unroll
                for (int q = 0; q < PER; ++q) {
                    const int i = tx + 32 * q;
                    if (q <= qj && i < j) v[q] -= A[tri(j, i)] * xj;
                }
            }
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                const int i = tx + 32 * q;
                if (i < D) b[i] = v[q];
            }
        }
    } else {
        for (int j = 0; j < D; ++j) {
            if (tid == 0) b[j] /= A[tri(j, j)];
            __syncthreads();
            const double yj = b[j];
            for (int i = j + 1 + tid; i < D; i += THREADS) {
                b[i] -= A[tri(i, j)] * yj;
            }
            __syncthreads();
        }
        for (int j = D - 1; j >= 0; --j) {
            if (tid == 0) b[j] /= A[tri(j, j)];
            __syncthreads();
            const double xj = b[j];
            for (int i = tid; i < j; i += THREADS) b[i] -= A[tri(j, i)] * xj;
            __syncthreads();
        }
    }
    __syncthreads();
    const bool ok = ok_sh != 0;
    for (int i = tid; i < D; i += THREADS) {
        const float d = (float)b[i];
        const float fm = free_mask[i] ? 1.0f : 0.0f;
        dx[i] = ((ok && isfinite(d)) ? d : 0.0f) * fm;
        dx_out[i] = dx[i];
    }
    __syncthreads();
    // ---- the retraction into the candidate tables
    if (f.in[POSE] != nullptr) {
        for (int r = tid; r < f.rows[POSE]; r += THREADS) {
            float E[7];
            se3_exp(dx + f.off[POSE] + 6 * r, E);
            se3_mul(E, f.in[POSE] + 7 * r, f.out[POSE] + 7 * r);
        }
    }
    for (int fam = VEL; fam <= BA; ++fam) {
        if (f.in[fam] == nullptr) continue;
        for (int e = tid; e < 3 * f.rows[fam]; e += THREADS) {
            f.out[fam][e] = f.in[fam][e] + dx[f.off[fam] + e];
        }
    }
    if (f.in[GDIR] != nullptr && tid == 0) {
        const float d3[3] = {dx[f.off[GDIR]], dx[f.off[GDIR] + 1], 0.0f};
        float ex[4], q[4];
        so3_exp(d3, ex);
        quat_mul(f.in[GDIR], ex, q);
        quat_normalize(q);
        for (int k = 0; k < 4; ++k) f.out[GDIR][k] = q[k];
    }
    if (f.in[SCALE] != nullptr && tid == 0) {
        f.out[SCALE][0] = f.in[SCALE][0] * expf(dx[f.off[SCALE]]);
    }
}

// the bytes of the packed system, its rhs and the step at D (shared
// memory up to SHARED_LIMIT, else the caller's global scratch)
size_t solve_bytes(int D) {
    return sizeof(double) * (tri(D, 0) + 2 * D) + sizeof(float) * D;
}

constexpr size_t SHARED_LIMIT = 220 * 1024;

}  // namespace

// H (D, D), g (D,) f64; pairs (P6, P6), rhs_pairs (P6,) f64 (P6 = 0 and
// null without landmarks); free_mask (D,) u8; lam () f32 on the device;
// eps the values' absolute damping.  ins / outs / rows / offs: host
// arrays of the six reduced families' device tables [pose (7), vel, bg,
// ba (3), gdir (4), scale (1)] (null absent), their candidate outputs,
// row counts and column offsets.  Writes dx (D,) f32 and the candidates.
// scratch: null when 8 (D (D + 1) / 2 + 2 D) + 4 D bytes fit in 220 KB,
// else that many bytes of device memory.
VSG_API int vsg_lm_solve(const double* H, const double* g,
                         const double* pairs, const double* rhs_pairs,
                         int P6, const uint8_t* free_mask, int D,
                         const float* lam, float eps, float* dx,
                         const float* const* ins, float* const* outs,
                         const int* rows, const int* offs, double* scratch,
                         cudaStream_t stream) {
    Fams f;
    for (int k = 0; k < 6; ++k) {
        f.in[k] = ins[k];
        f.out[k] = outs[k];
        f.rows[k] = rows[k];
        f.off[k] = offs[k];
    }
    const size_t bytes = solve_bytes(D);
    size_t shmem = 0;
    if (bytes <= SHARED_LIMIT) {
        shmem = bytes;
        scratch = nullptr;
        const cudaError_t err = cudaFuncSetAttribute(
            lm_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shmem);
        if (err != cudaSuccess) return (int)err;
    } else if (scratch == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    lm_solve_kernel<<<1, THREADS, shmem, stream>>>(
        H, g, pairs, rhs_pairs, P6, free_mask, D, lam, eps, dx, f, scratch);
    return (int)cudaGetLastError();
}
