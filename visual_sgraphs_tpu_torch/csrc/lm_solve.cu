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
// Design: a blocked right-looking Cholesky on 16 x 16 float64 tiles.  The
// lower triangle of S (padded to a multiple of 16 with identity rows)
// lives tile-major in one block's dynamic shared memory: 2 KB a tile,
// columns swizzled by row so that the tensor-core fragments and the
// triangular solves' column reads hit distinct banks; 55 tiles (110 KB)
// at D = 150, up to 105 tiles at D <= 224, global scratch (in L2) past
// the 227 KB a block may use.  The prologue writes each tile straight from
// its (i, j): H's free entries by asynchronous copies, masked ones as 0,
// then the diagonal's damping and the landmarks' pairs.  Each panel j then
// takes two block barriers:
//   A. the block solves the tiles below the diagonal against L_jj (TRSM,
//      one row a thread, by the inverse pivots) while thread 0 solves
//      y_j = L_jj^-1 b_j (the forward solve, folded in);
//   B. warps 1.. subtract L_ij y_j from the rhs and run the trailing
//      update A_ik -= L_ij L_kj^T, one 16 x 16 output tile a warp, on the
//      float64 tensor cores (two mma.sync m16n8k16 .f64 a tile; wgmma
//      takes no float64), while warp 0 updates the next diagonal tile
//      first and factors it in registers (a row a lane, rsqrt pivots, the
//      next pivot broadcast by a shuffle ahead of the rank-1 update).
// The backward solve takes one barrier a block: thread 0 solves x_j while
// the block subtracts x_{j+1} from the blocks above.  The step's zeroing,
// the float32 step and the retraction epilogue follow.
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
constexpr int WARPS = THREADS / 32;
constexpr int NB = 16;  // tile edge
constexpr int TILE = NB * NB;
constexpr unsigned FULL = 0xffffffffu;
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

// lower-triangular tile (i, k), i >= k, tile-row-major
__host__ __device__ __forceinline__ int tile_id(int i, int k) {
    return i * (i + 1) / 2 + k;
}

// element (r, c) of a tile: the column XOR-swizzled by (r mod 4) so that
// a half-warp's share of an mma fragment (4 rows x 4 columns) and a column
// read across 16 rows each spread over all 16 double banks
__device__ __forceinline__ int el(int r, int c) {
    return r * NB + (c ^ ((r & 3) << 2));
}

// d[0..3] += A B: one lane's share of a 16 x 8 += (16 x 16) (16 x 8)
// float64 product (Hopper's m16n8k16; lane = 4 g + t holds A rows g and
// g + 8 at columns t, t + 4, t + 8, t + 12, B rows t + 4 v at column g,
// and D rows g, g + 8 at columns 2 t, 2 t + 1)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

// C -= Li Lk^T for 16 x 16 tiles, by one warp (all lanes): two products,
// every operand loaded before either is issued and both in flight at once
__device__ __forceinline__ void tile_update(double* C, const double* Li,
                                            const double* Lk, int lane) {
    const int g = lane >> 2, t = lane & 3;
    double a[8], b[2][4], d[2][4];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
        a[v] = -Li[el(g + 8 * (v & 1), t + 4 * (v >> 1))];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            b[h][v] = Lk[el(8 * h + g, t + 4 * v)];
            d[h][v] = C[el(g + 8 * (v >> 1), 8 * h + 2 * t + (v & 1))];
        }
    }
    dmma(d[0], a, b[0]);
    dmma(d[1], a, b[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            C[el(g + 8 * (v >> 1), 8 * h + 2 * t + (v & 1))] = d[h][v];
        }
    }
}

// Factor a diagonal tile in place (L L^T, lower; the upper part is left
// undefined) by one warp: lane r (and r + 16) holds row r.  Writes the
// inverse pivots to inv[0..15]; false when a pivot is not positive.  The
// next pivot (lane c + 1's own update) is broadcast by a shuffle ahead of
// the rest of the rank-1 update, whose column goes through the tile in
// shared memory (one store, then broadcast loads), so a column costs one
// rsqrt, one multiply, one fused multiply-add and one shuffle on the
// dependent chain.
__device__ __forceinline__ bool factor_diag(double* T, double* inv,
                                            int lane) {
    const int r = lane & (NB - 1);
    double a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = T[el(r, c)];
    bool ok = true;
    double d = __shfl_sync(FULL, a[0], 0);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
        ok = ok && d > 0.0;
        const double s = rsqrt(d);
        const double l = a[c] * s;  // L[r][c]; sqrt(d) on the diagonal
        if (lane < NB) T[el(r, c)] = l;
        if (lane == c) inv[c] = s;
        if (c + 1 < NB) {
            d = __shfl_sync(FULL, fma(-l, l, a[c + 1]), c + 1);
            __syncwarp();
#pragma unroll
            for (int k = c + 1; k < NB; ++k) {
                a[k] = fma(-l, T[el(k, c)], a[k]);
            }
        }
    }
    return ok;
}

// In one thread's registers, a <- L^-1 a (kLower; a row of a tile below
// the diagonal solves x L^T = a the same way) or a <- L^-T a, for L a
// factored diagonal tile and inv its inverse pivots: a chain of 16
// multiply / fused multiply-add pairs, no shuffles.
template <bool kLower>
__device__ __forceinline__ void tile_solve(double (&a)[NB], const double* L,
                                           const double* inv) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
        const int k = kLower ? n : NB - 1 - n;
        a[k] *= inv[k];
#pragma unroll
        for (int m = 0; m < NB; ++m) {
            if (kLower ? m > k : m < k) {
                a[m] = fma(-a[k], kLower ? L[el(m, k)] : L[el(k, m)], a[m]);
            }
        }
    }
}

// One row of a tile below the diagonal: x L^T = a, in place
__device__ __forceinline__ void trsm_row(double* A, const double* L,
                                         const double* inv, int r) {
    double a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = A[el(r, c)];
    tile_solve<true>(a, L, inv);
#pragma unroll
    for (int c = 0; c < NB; ++c) A[el(r, c)] = a[c];
}

// One block of the rhs: v <- L^-1 v (kLower) or L^-T v
template <bool kLower>
__device__ __forceinline__ void vec_solve(double* v, const double* L,
                                          const double* inv) {
    double a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = v[c];
    tile_solve<kLower>(a, L, inv);
#pragma unroll
    for (int c = 0; c < NB; ++c) v[c] = a[c];
}

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
lm_solve_kernel(const double* __restrict__ H, const double* __restrict__ g,
                const double* __restrict__ pairs,
                const double* __restrict__ rhs_pairs, int P6,
                const uint8_t* __restrict__ free_mask, int D,
                const float* __restrict__ lam_ptr, float eps,
                float* __restrict__ dx_out, Fams f, double* scratch) {
    extern __shared__ double sh[];
    __shared__ int ok_sh;
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
                    cp_async8(to, Hi + j);
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
    // ---- Cholesky, a 16-column panel a step, with L y = b folded in:
    // (A) thread 0 solves y_j = L_jj^-1 b_j while warps 1.. solve the
    // tiles below L_jj; (B) warps 1.. take b_i -= L_ij y_j (i > j), then
    // the trailing tiles, while warp 0 updates and factors L_nn
    bool ok = true;  // warp 0 factors every diagonal tile
    if (warp == 0) ok = factor_diag(T, inv, lane);
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
        const double* Ljj = T + (size_t)tile_id(j, j) * TILE;
        const int below = (nt - j - 1) * NB;
        if (tid == 0) vec_solve<true>(bv + j * NB, Ljj, inv + j * NB);
        for (int q = tid - 32; warp > 0 && q < below; q += THREADS - 32) {
            trsm_row(T + (size_t)tile_id(j + 1 + q / NB, j) * TILE, Ljj,
                     inv + j * NB, q % NB);
        }
        __syncthreads();
        if (j + 1 == nt) break;
        const int n = j + 1;
        if (warp == 0) {
            double* Tnn = T + (size_t)tile_id(n, n) * TILE;
            const double* Lnj = T + (size_t)tile_id(n, j) * TILE;
            tile_update(Tnn, Lnj, Lnj, lane);
            __syncwarp();
            ok = factor_diag(Tnn, inv + n * NB, lane) && ok;
        } else {
            for (int q = tid - 32; q < below; q += THREADS - 32) {
                const int i = n + q / NB, rr = q % NB;
                const double* A = T + (size_t)tile_id(i, j) * TILE;
                double acc = bv[i * NB + rr];
#pragma unroll
                for (int c = 0; c < NB; ++c) {
                    acc = fma(-A[el(rr, c)], bv[j * NB + c], acc);
                }
                bv[i * NB + rr] = acc;
            }
            __syncwarp();
            for (int k = n, q = 0; k < nt; ++k) {
                for (int i = k + (k == n); i < nt; ++i, ++q) {
                    if (q % (WARPS - 1) != warp - 1) continue;
                    tile_update(T + (size_t)tile_id(i, k) * TILE,
                                T + (size_t)tile_id(i, j) * TILE,
                                T + (size_t)tile_id(k, j) * TILE, lane);
                }
            }
        }
        __syncthreads();
    }
    if (tid == 0) ok_sh = ok;
    // ---- L^T x = y, one barrier a block: warp 0 subtracts x_{j+1} from
    // block j and thread 0 solves x_j, while warps 1.. subtract x_{j+1}
    // from the blocks above j
    for (int j = nt - 1; j >= 0; --j) {
        if (warp == 0) {
            if (j + 1 < nt && lane < NB) {
                const double* A = T + (size_t)tile_id(j + 1, j) * TILE;
                double acc = bv[j * NB + lane];
#pragma unroll
                for (int rr = 0; rr < NB; ++rr) {
                    acc = fma(-A[el(rr, lane)], bv[(j + 1) * NB + rr], acc);
                }
                bv[j * NB + lane] = acc;
            }
            __syncwarp();
            if (lane == 0) {
                vec_solve<false>(bv + j * NB, T + (size_t)tile_id(j, j) * TILE,
                                 inv + j * NB);
            }
        } else if (j + 1 < nt) {
            for (int q = tid - 32; q < j * NB; q += THREADS - 32) {
                const int i = q / NB, c = q % NB;
                const double* A = T + (size_t)tile_id(j + 1, i) * TILE;
                double acc = bv[i * NB + c];
#pragma unroll
                for (int rr = 0; rr < NB; ++rr) {
                    acc = fma(-A[el(rr, c)], bv[(j + 1) * NB + rr], acc);
                }
                bv[i * NB + c] = acc;
            }
        }
        __syncthreads();
    }
    const bool solved = ok_sh != 0;
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
size_t tile_bytes(int nt) {
    return sizeof(double) * TILE * (size_t)tile_id(nt, 0);
}

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
