// A dense float64 Cholesky solve in one block: K22c (lm_solve.cu) and
// K26 (ba_solve.cu) share it.
//
// A blocked right-looking Cholesky on 16 x 16 float64 tiles.  The lower
// triangle of the system (padded to a multiple of 16 with identity rows)
// lives tile-major in ``T``, 2 KB a tile, columns swizzled by row so that
// the tensor-core fragments and the triangular solves' column reads hit
// distinct banks: in the block's dynamic shared memory when it fits, else
// in global scratch (in L2).  Each panel j takes two block barriers:
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
// the block subtracts x_{j+1} from the blocks above.  Every sum runs in
// an order fixed by D alone, so the result is bitwise equal from launch
// to launch.
#pragma once

#include "common.cuh"

namespace chol {

constexpr int NB = 16;  // tile edge
constexpr int TILE = NB * NB;
constexpr unsigned FULL = 0xffffffffu;

// lower-triangular tile (i, k), i >= k, tile-row-major
__host__ __device__ __forceinline__ int tile_id(int i, int k) {
    return i * (i + 1) / 2 + k;
}

// float64 entries of the tiles of an nt-tile-wide system
__host__ __device__ __forceinline__ size_t tile_doubles(int nt) {
    return (size_t)TILE * tile_id(nt, 0);
}

// element (r, c) of a tile: the column XOR-swizzled by (r mod 4) so that
// a half-warp's share of an mma fragment (4 rows x 4 columns) and a column
// read across 16 rows each spread over all 16 double banks
__device__ __forceinline__ int el(int r, int c) {
    return r * NB + (c ^ ((r & 3) << 2));
}

// the address of entry (i, j), i >= j, of the system
__device__ __forceinline__ double* entry(double* T, int i, int j) {
    return T + (size_t)tile_id(i / NB, j / NB) * TILE + el(i % NB, j % NB);
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

// L^T x = y in place (bv <- x) for the factored tiles that ``at(i, k)``
// addresses (a device pointer to tile (i, k), i >= k: in this block's
// shared memory, in global memory or in another CTA's of the cluster), by
// all kThreads threads of the block, one barrier a block: warp 0
// subtracts x_{j+1} from block j and thread 0 solves x_j, while warps 1..
// subtract x_{j+1} from the blocks above j.
template <int kThreads, class TileAt>
__device__ void backward(TileAt at, double* bv, const double* inv, int nt) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int j = nt - 1; j >= 0; --j) {
        if (warp == 0) {
            if (j + 1 < nt && lane < NB) {
                const double* A = at(j + 1, j);
                double acc = bv[j * NB + lane];
#pragma unroll
                for (int rr = 0; rr < NB; ++rr) {
                    acc = fma(-A[el(rr, lane)], bv[(j + 1) * NB + rr], acc);
                }
                bv[j * NB + lane] = acc;
            }
            __syncwarp();
            if (lane == 0) {
                vec_solve<false>(bv + j * NB, at(j, j), inv + j * NB);
            }
        } else if (j + 1 < nt) {
            for (int q = tid - 32; q < j * NB; q += kThreads - 32) {
                const int i = q / NB, c = q % NB;
                const double* A = at(j + 1, i);
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
}

// Solve T x = bv in place (bv <- x) for the nt-tile system whose lower
// triangle ``T`` holds (overwritten by its factor), by all kThreads
// threads of the block; ``inv`` takes nt 16 inverse pivots.  Returns, to
// every thread, whether every pivot was positive (when not, bv holds no
// solution).  Starts and ends on a block barrier.
template <int kThreads>
__device__ bool solve(double* T, double* bv, double* inv, int nt) {
    constexpr int kWarps = kThreads / 32;
    __shared__ int ok_sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
        for (int q = tid - 32; warp > 0 && q < below; q += kThreads - 32) {
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
            for (int q = tid - 32; q < below; q += kThreads - 32) {
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
                    if (q % (kWarps - 1) != warp - 1) continue;
                    tile_update(T + (size_t)tile_id(i, k) * TILE,
                                T + (size_t)tile_id(i, j) * TILE,
                                T + (size_t)tile_id(k, j) * TILE, lane);
                }
            }
        }
        __syncthreads();
    }
    if (tid == 0) ok_sh = ok;
    backward<kThreads>(
        [T](int i, int k) { return T + (size_t)tile_id(i, k) * TILE; }, bv,
        inv, nt);
    return ok_sh != 0;
}

}  // namespace chol
