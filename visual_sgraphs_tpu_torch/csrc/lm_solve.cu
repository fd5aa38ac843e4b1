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
// chain of D dependent steps; the bytes (H once) take ~0.06 us.
//
// Design: the blocked right-looking Cholesky of chol.cuh on 16 x 16
// float64 tiles (DMMA trailing update, the forward solve folded into the
// panels), in one block.  The tiles live in dynamic shared memory: 55
// tiles (110 KB) at D = 150, up to 105 tiles at D <= 224, global scratch
// (in L2) past the 227 KB a block may use.  The prologue writes each tile
// straight from its (i, j): H's free entries by asynchronous copies,
// masked ones as 0, then the diagonal's damping and the landmarks' pairs.
// The step's zeroing, the float32 step and the retraction epilogue follow.
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
#include "chol.cuh"
#include "lie.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// the shared memory one block may use on the H100 (cudaFuncSetAttribute's
// limit); lm_kernels.py::_solve_layout makes the same choice
constexpr size_t SHARED_MAX = 232448;
constexpr int POSE = 0, VEL = 1, BG = 2, BA = 3, GDIR = 4, SCALE = 5;
constexpr int TANGENT[6] = {6, 3, 3, 3, 2, 1};
constexpr int STORE[6] = {7, 3, 3, 3, 4, 1};

struct Fams {
    const float* in[6];
    float* out[6];
    int rows[6];
    int off[6];
};

using chol::el;
using chol::NB;
using chol::TILE;
using chol::tile_id;

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
lm_solve_kernel(const double* __restrict__ H, const double* __restrict__ g,
                const double* __restrict__ pairs,
                const double* __restrict__ rhs_pairs, int P6,
                const uint8_t* __restrict__ free_mask, int D,
                const float* __restrict__ lam_ptr, float eps,
                float* __restrict__ dx_out, Fams f, double* scratch) {
    extern __shared__ double sh[];
    const int nt = (D + NB - 1) / NB;
    double* bv = sh;               // (nt 16) the rhs, then y, then x
    double* inv = bv + nt * NB;    // (nt 16) inverse pivots
    float* dx = reinterpret_cast<float*>(inv + nt * NB);  // (nt 16)
    double* T = kShared ? inv + nt * NB + nt * NB / 2 : scratch;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const double lam = (double)lam_ptr[0];
    // ---- the damped, reduced, masked system, its lower triangle (the
    // upper part of a diagonal tile is never read).  The mask (into inv,
    // free until the factorisation) and the rhs first; then a row a warp:
    // a masked entry is written as 0 (a row past D as an identity row), a
    // free one copied from H (asynchronously into shared memory, every copy
    // in flight at once); then the diagonal's damping and the landmarks'
    // pairs on the first P6 rows
    double* fm = inv;
    for (int i = tid; i < nt * NB; i += THREADS) {
        double r = 0.0, f = 0.0;
        if (i < D) {
            f = free_mask[i] ? 1.0 : 0.0;
            r = -g[i];
            if (i < P6) r += rhs_pairs[i];
            r *= f;
        }
        fm[i] = f;
        bv[i] = r;
    }
    __syncthreads();
    for (int i = warp; i < nt * NB; i += WARPS) {
        double* Ti = T + (size_t)tile_id(i / NB, 0) * TILE;
        const double* Hi = H + (size_t)min(i, D - 1) * D;
        const bool row = fm[i] != 0.0;
        for (int j = lane; j < i; j += 32) {
            double* to = Ti + (j / NB) * TILE + el(i % NB, j % NB);
            if (row && fm[j] != 0.0) {
                if (kShared) {
                    chol::cp_async8(to, Hi + j);
                } else {
                    *to = Hi[j];
                }
            } else {
                *to = 0.0;
            }
        }
        if (lane == 0 && !row) Ti[(i / NB) * TILE + el(i % NB, i % NB)] = 1.0;
    }
    if (kShared) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    for (int i = tid; i < D; i += THREADS) {
        if (fm[i] == 0.0) continue;
        double a = H[(size_t)i * D + i];
        a += lam * fmax(a, 1e-6) + (double)eps;
        if (i < P6) a -= pairs[i * P6 + i];
        T[(size_t)tile_id(i / NB, i / NB) * TILE + el(i % NB, i % NB)] = a;
    }
#pragma unroll 4
    for (int e = tid; e < P6 * P6; e += THREADS) {
        const int i = e / P6, j = e - i * P6;
        if (j < i && fm[i] != 0.0 && fm[j] != 0.0) {
            T[(size_t)tile_id(i / NB, j / NB) * TILE + el(i % NB, j % NB)] -=
                pairs[e];
        }
    }
    __syncthreads();
    const bool solved = chol::solve<THREADS>(T, bv, inv, nt);
    for (int i = tid; i < D; i += THREADS) {
        const float d = (float)bv[i];
        const float fm = free_mask[i] ? 1.0f : 0.0f;
        dx[i] = ((solved && isfinite(d)) ? d : 0.0f) * fm;
        dx_out[i] = dx[i];
    }
    __syncthreads();
    // ---- the retraction into the candidate tables
    if (f.in[POSE] != nullptr) {
        for (int k = tid; k < f.rows[POSE]; k += THREADS) {
            float E[7];
            se3_exp(dx + f.off[POSE] + 6 * k, E);
            se3_mul(E, f.in[POSE] + 7 * k, f.out[POSE] + 7 * k);
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

// dynamic shared memory: the rhs and inverse pivots (float64) and the
// step (float32), nt 16 entries each, plus the tiles when they fit
size_t small_bytes(int nt) { return (size_t)nt * NB * (8 + 8 + 4); }
size_t tile_bytes(int nt) { return sizeof(double) * chol::tile_doubles(nt); }

template <bool kShared>
int launch(size_t shmem, const double* H, const double* g,
           const double* pairs, const double* rhs_pairs, int P6,
           const uint8_t* free_mask, int D, const float* lam, float eps,
           float* dx, const Fams& f, double* scratch, cudaStream_t stream) {
    // set once a process (the attribute is per function, not per call)
    static size_t set = 0;
    if (shmem > set) {
        const cudaError_t err = cudaFuncSetAttribute(
            lm_solve_kernel<kShared>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err != cudaSuccess) return (int)err;
        set = shmem;
    }
    lm_solve_kernel<kShared><<<1, THREADS, shmem, stream>>>(
        H, g, pairs, rhs_pairs, P6, free_mask, D, lam, eps, dx, f, scratch);
    return (int)cudaGetLastError();
}

}  // namespace

// H (D, D), g (D,) f64; pairs (P6, P6), rhs_pairs (P6,) f64 (P6 = 0 and
// null without landmarks); free_mask (D,) u8; lam () f32 on the device;
// eps the values' absolute damping.  in0..in5: the six reduced families'
// device tables [pose (7), vel, bg, ba (3), gdir (4), scale (1)] (null
// absent); rows: a host array of their row counts.  out: D floats of dx,
// then each present family's candidate table in that order.  scratch:
// null when the tiles fit in shared memory beside the vectors (D <= 224),
// else 2 KB for each of the nt (nt + 1) / 2 tiles, nt = ceil(D / 16).
VSG_API int vsg_lm_solve(const double* H, const double* g,
                         const double* pairs, const double* rhs_pairs,
                         int P6, const uint8_t* free_mask, int D,
                         const float* lam, float eps, float* out,
                         const float* in0, const float* in1,
                         const float* in2, const float* in3,
                         const float* in4, const float* in5, const int* rows,
                         double* scratch, cudaStream_t stream) {
    Fams f;
    const float* ins[6] = {in0, in1, in2, in3, in4, in5};
    float* o = out + D;
    for (int k = 0, off = 0; k < 6; ++k) {
        f.in[k] = ins[k];
        f.out[k] = ins[k] != nullptr ? o : nullptr;
        f.rows[k] = rows[k];
        f.off[k] = off;
        o += STORE[k] * rows[k];
        off += TANGENT[k] * rows[k];
    }
    const int nt = (D + NB - 1) / NB;
    const size_t small = small_bytes(nt);
    if (small + tile_bytes(nt) <= SHARED_MAX) {
        return launch<true>(small + tile_bytes(nt), H, g, pairs, rhs_pairs,
                            P6, free_mask, D, lam, eps, out, f, nullptr,
                            stream);
    }
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch<false>(small, H, g, pairs, rhs_pairs, P6, free_mask, D,
                         lam, eps, out, f, scratch, stream);
}
