// K26: the damped Schur solve and retraction of the Schur BAs, one launch
// an iteration.
//
// Replaces the reduced solve and the retraction of
// visual_sgraphs_tpu/optim/fast_ba.py:163-178 (fast_local_ba's one_iter,
// D = 6L = 66), :389-421 (fast_scenegraph_ba, D = 6L + 3P + 3R + 6Dn =
// 402) and visual_sgraphs_tpu/parallel/dist_ba.py:289-301 (the global
// BA's _step_body, D = 6K = 768):
//   S <- S + diag(lam max(diag S, 1e-6) + 1e-5),
//   S <- S f f^T + diag(1 - f), rhs <- rhs f   (the gauge mask),
//   dx = S^-1 rhs by Cholesky, zeroed when not finite or when the
//   factorisation fails, times f,
// then the reduced tangent [kf (L, 6) | plane (P, 3) | room (R, 3) | door
// (Dn, 6)] moves each variable by its slice (a zero step where it is
// fixed): poses and doors to normalize(exp(d) T), planes by the chart's
// oplus (core/plane.py:54), rooms by addition.  S and rhs come from K8
// (parallel/dist_ba.py::local_reduced_system) or K21 (the scene-graph
// system); the landmarks' back-substitution and point update follow in
// K8's second launch.
//
// What bounds it here: latency.  A Cholesky of ~D^3 / 6 multiply-adds
// (10.8 M at D = 402, 75.5 M at D = 768) and two triangular solves, each
// a chain of D dependent steps; the bytes (S once) take ~0.2-0.7 us.
//
// Design: the blocked right-looking Cholesky of chol.cuh (16 x 16
// float64 tiles, DMMA trailing update).  Up to D = 224 (the windowed BA's
// 66) the lower triangle fits one SM's shared memory, and one block of 512
// threads runs it there, as K22c does.  Past it (D = 402: 351 tiles, 702
// KB; D = 768: 1176 tiles, 2.35 MB) one block over tiles in L2 took 0.48
// and 2.28 ms (NVIDIA H100 80GB HBM3, 700 W): its 15 worker warps each
// walked hundreds of trailing tiles one L2 round trip at a time.  So there
// one thread-block cluster of 16 CTAs (a non-portable size) shares the
// panels' work, tile t in CTA t mod 16: up to D = 896 (1596 tiles, 200 KB
// a CTA) the tiles live in the cluster's distributed shared memory, past
// it (the global BA at 256 keyframes, D = 1536: 4656 tiles, 9.5 MB) in
// global scratch, each CTA's share in a slab of its own.  A panel takes
// two cluster barriers; each CTA updates its own trailing tiles, reading
// the panel's tiles from their owners, and CTA 0 keeps the rhs and runs
// the forward and backward solves.
//
// Precision: the float32 system is factored in float64 (a float32
// factorisation of these systems parts from any other float32 solve by
// ~1e-3 m, ROADMAP queue 3), in an order fixed by D: the step is bitwise
// equal from launch to launch.  The step is returned in float32, and the
// retraction is float32, as the reference's.
#include <cooperative_groups.h>

#include "chol.cuh"
#include "lie.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// the shared memory one block may use on the H100 (cudaFuncSetAttribute's
// limit)
constexpr size_t SHARED_MAX = 232448;
constexpr int CLUSTER = 16;  // CTAs of the cluster path

using chol::el;
using chol::NB;
using chol::TILE;
using chol::tile_id;

struct Vars {
    const float* poses;  // (L, 7)
    const float* planes;  // (P, 4)
    const float* rooms;  // (R, 3)
    const float* doors;  // (Dn, 7)
    int L, P, R, Dn;
};

// normalize(exp(d) T) for an SE(3) pose [q, t] and a tangent [rho, omega]
__device__ void pose_retract(const float* T, const float* d, float* out) {
    float E[7];
    se3_exp(d, E);
    se3_mul(E, T, out);
    quat_normalize(out);
}

// core/plane.py::oplus: the normal turned by the chart's (azimuth,
// elevation) step in the frame of the plane's own normal rotation, the
// distance moved by the third component, renormalised
__device__ void plane_oplus(const float* c, const float* d, float* out) {
    const float ce_d = cosf(d[1]), se_d = sinf(d[1]);
    const float nl[3] = {ce_d * cosf(d[0]), ce_d * sinf(d[0]), se_d};
    const float az = atan2f(c[1], c[0]);
    const float el_ = atan2f(c[2], sqrtf(c[0] * c[0] + c[1] * c[1]));
    const float ca = cosf(az), sa = sinf(az), ce = cosf(el_), se = sinf(el_);
    const float R[9] = {ca * ce, -sa, -ca * se, sa * ce, ca,
                        -sa * se, se, 0.0f, ce};
    float v[4];
    for (int i = 0; i < 3; ++i) {
        v[i] = R[3 * i] * nl[0] + R[3 * i + 1] * nl[1] + R[3 * i + 2] * nl[2];
    }
    v[3] = -(-c[3] + d[2]);
    const float n = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                          1.17549435e-38f);
    for (int i = 0; i < 4; ++i) out[i] = v[i] / n;
}

// The retraction, a variable a thread of the block: ``dx`` the step, a
// zero step where a variable's first tangent row is masked; the moved
// poses, planes, rooms and doors into ``o`` in that order (not inlined:
// it runs once, after the solve, and its registers stay out of the
// solve's)
__device__ __noinline__ void retract(const float* dx, const float* free_mask,
                                     int D, const Vars& v, float* o) {
    const int n_var = v.L + v.P + v.R + v.Dn;
    const int off_pl = 6 * v.L, off_rm = off_pl + 3 * v.P,
              off_dr = off_rm + 3 * v.R;
    for (int k = threadIdx.x; k < n_var; k += blockDim.x) {
        float step[6];
        if (k < v.L) {
            for (int c = 0; c < 6; ++c) {
                step[c] = free_mask[6 * k] != 0.0f ? dx[6 * k + c] : 0.0f;
            }
            pose_retract(v.poses + 7 * k, step, o + 7 * k);
        } else if (k < v.L + v.P) {
            const int p = k - v.L, r0 = off_pl + 3 * p;
            for (int c = 0; c < 3; ++c) {
                step[c] = free_mask[r0] != 0.0f ? dx[r0 + c] : 0.0f;
            }
            plane_oplus(v.planes + 4 * p, step, o + 7 * v.L + 4 * p);
        } else if (k < v.L + v.P + v.R) {
            const int r = k - v.L - v.P, r0 = off_rm + 3 * r;
            float* to = o + 7 * v.L + 4 * v.P + 3 * r;
            for (int c = 0; c < 3; ++c) {
                to[c] = v.rooms[3 * r + c] +
                        (free_mask[r0] != 0.0f ? dx[r0 + c] : 0.0f);
            }
        } else {
            const int d = k - v.L - v.P - v.R, r0 = off_dr + 6 * d;
            for (int c = 0; c < 6; ++c) {
                step[c] = free_mask[r0] != 0.0f ? dx[r0 + c] : 0.0f;
            }
            pose_retract(v.doors + 7 * d, step,
                         o + 7 * v.L + 4 * v.P + 3 * v.R + 7 * d);
        }
    }
}

// The damped, masked float64 value of S's entry (i, j), i >= j, of row
// ``Si``: 0 where row or column is masked (1 on a masked diagonal, and on
// the padding rows past D), lam max(a, 1e-6) + 1e-5 added on the diagonal
__device__ __forceinline__ double system_entry(const float* Si,
                                               const float* free_mask, int D,
                                               double lam, int i, int j) {
    const bool row = i < D && free_mask[i] != 0.0f;
    if (i == j) {
        if (!row) return 1.0;
        const double a = (double)Si[i];
        return a + (lam * fmax(a, 1e-6) + 1e-5);
    }
    return row && free_mask[j] != 0.0f ? (double)Si[j] : 0.0;
}

// The one-block path (D <= 224): the system written tile by tile into
// this block's shared memory, chol::solve, the step and the retraction
__global__ void __launch_bounds__(THREADS)
ba_solve_block(const float* __restrict__ S, const float* __restrict__ rhs,
               const float* __restrict__ free_mask, int D, double lam,
               Vars v, float* __restrict__ out) {
    extern __shared__ double sh[];
    const int nt = (D + NB - 1) / NB;
    double* bv = sh;             // (nt 16) the rhs, then y, then x
    double* inv = bv + nt * NB;  // (nt 16) inverse pivots
    float* dx = reinterpret_cast<float*>(inv + nt * NB);  // (nt 16)
    double* T = inv + nt * NB + nt * NB / 2;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // the masked rhs, then the damped, masked system's lower triangle (the
    // upper part of a diagonal tile is never read), a row a warp
    for (int i = tid; i < nt * NB; i += THREADS) {
        bv[i] = i < D ? (double)rhs[i] * (double)free_mask[i] : 0.0;
    }
    for (int i = warp; i < nt * NB; i += WARPS) {
        const float* Si = S + (size_t)min(i, D - 1) * D;
        for (int j = lane; j <= i; j += 32) {
            *chol::entry(T, i, j) = system_entry(Si, free_mask, D, lam, i, j);
        }
    }
    __syncthreads();
    const bool solved = chol::solve<THREADS>(T, bv, inv, nt);
    for (int i = tid; i < D; i += THREADS) {
        const double x = bv[i];
        dx[i] = ((solved && isfinite(x)) ? (float)x : 0.0f) * free_mask[i];
        out[i] = dx[i];
    }
    __syncthreads();
    retract(dx, free_mask, D, v, out + D);
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The cluster path (D > 224): one cluster of C CTAs keeps the lower
// triangle's tiles, tile t in CTA t mod C (slot t / C) of its distributed
// shared memory (kDsmem) or of its slab of ``scratch`` in global memory
// (the cluster barriers' release / acquire order those writes too), and
// the rhs in CTA 0.  Each panel j takes two cluster barriers:
//   A. every CTA copies L_jj from its owner and factors the copy (warp 0;
//      the copies are equal), CTA 0's thread 0 solves y_j, and each CTA
//      solves the rows of its own tiles below L_jj, 16 threads a tile;
//   B. the owner of L_jj stores the factor, each CTA subtracts its tiles'
//      L_ij y_j from CTA 0's rhs, and its warps update its own trailing
//      tiles (DMMA), reading L_ij and L_kj from their owners.
// Then CTA 0 solves L^T x = y reading the factor from every CTA, a last
// barrier keeps the cluster's shared memory alive until it has, and CTA
// 0 retracts.  Every entry is summed in the panels' order: bitwise equal
// from launch to launch, and to the one-block path.
template <bool kDsmem>
__global__ void __launch_bounds__(THREADS)
ba_solve_cluster(const float* __restrict__ S, const float* __restrict__ rhs,
                 const float* __restrict__ free_mask, int D, double lam,
                 Vars v, float* __restrict__ out, double* scratch) {
    constexpr int C = CLUSTER;
    extern __shared__ double sh[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int nt = (D + NB - 1) / NB, n_tiles = tile_id(nt, 0);
    const int slots = (n_tiles + C - 1) / C;
    // (slots, TILE) this CTA's own tiles, then (TILE) its copy of L_jj
    double* tiles = kDsmem ? sh : scratch + (size_t)rank * slots * TILE;
    double* Lw = kDsmem ? tiles + (size_t)slots * TILE : sh;
    double* inv = Lw + TILE;                        // (nt 16) inverse pivots
    double* bv = inv + nt * NB;                     // (nt 16) CTA 0: rhs, y, x
    float* dx = reinterpret_cast<float*>(bv + nt * NB);  // (nt 16) CTA 0
    __shared__ int ok_sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    double* bv0 = cluster.map_shared_rank(bv, 0);
    auto mine = [&](int i, int k) {
        return tiles + (size_t)(tile_id(i, k) / C) * TILE;
    };
    auto at = [&](int i, int k) {
        const int t = tile_id(i, k);
        double* base = kDsmem ? cluster.map_shared_rank(tiles, t % C)
                              : scratch + (size_t)(t % C) * slots * TILE;
        return base + (size_t)(t / C) * TILE;
    };
    // ---- this CTA's tiles of the damped, masked system, a tile a warp
    for (int s = warp; s < slots; s += WARPS) {
        const int t = s * C + rank;
        if (t >= n_tiles) break;
        int ti = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
        while (tile_id(ti + 1, 0) <= t) ++ti;
        while (tile_id(ti, 0) > t) --ti;
        const int tk = t - tile_id(ti, 0);
        double* T = tiles + (size_t)s * TILE;
        for (int e = lane; e < TILE; e += 32) {
            const int r = e / NB, c = (e % NB) ^ ((r & 3) << 2);
            const int i = ti * NB + r, j = tk * NB + c;
            T[e] = j <= i ? system_entry(S + (size_t)min(i, D - 1) * D,
                                         free_mask, D, lam, i, j)
                          : 0.0;
        }
    }
    if (rank == 0) {
        for (int i = tid; i < nt * NB; i += THREADS) {
            bv[i] = i < D ? (double)rhs[i] * (double)free_mask[i] : 0.0;
        }
    }
    cluster_sync();
    bool ok = true;  // warp 0 of every CTA factors every diagonal tile
    for (int j = 0; j < nt; ++j) {
        double* invj = inv + j * NB;
        if (warp == 0) {
            const double* src = at(j, j);
            for (int e = lane; e < TILE; e += 32) Lw[e] = src[e];
            __syncwarp();
            ok = chol::factor_diag(Lw, invj, lane) && ok;
        }
        __syncthreads();
        if (rank == 0 && tid == 0) {
            chol::vec_solve<true>(bv + j * NB, Lw, invj);
        }
        // this CTA's tiles below L_jj, the q-th by threads 16 (q mod 32) ..
        for (int i = j + 1, q = 0; i < nt; ++i) {
            if (tile_id(i, j) % C != rank) continue;
            if (q++ % (THREADS / NB) == tid / NB) {
                chol::trsm_row(mine(i, j), Lw, invj, tid % NB);
            }
        }
        cluster_sync();
        if (j + 1 == nt) break;
        if (tile_id(j, j) % C == rank) {
            for (int e = tid; e < TILE; e += THREADS) mine(j, j)[e] = Lw[e];
        }
        for (int i = j + 1, q = 0; i < nt; ++i) {
            if (tile_id(i, j) % C != rank) continue;
            if (q++ % (THREADS / NB) != tid / NB) continue;
            const int r = tid % NB;
            const double* A = mine(i, j);
            double acc = bv0[i * NB + r];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                acc = fma(-A[el(r, c)], bv0[j * NB + c], acc);
            }
            bv0[i * NB + r] = acc;
        }
        // this CTA's trailing tiles (i, k), j < k <= i: in row i they are
        // every C-th from the first k whose tile falls to this CTA
        for (int i = j + 1, n = 0; i < nt; ++i) {
            const int base = tile_id(i, 0);
            int k = j + 1 + ((rank - (base + j + 1)) % C + C) % C;
            for (; k <= i; k += C, ++n) {
                if (n % WARPS != warp) continue;
                chol::tile_update(mine(i, k), at(i, j), at(k, j), lane);
            }
        }
        cluster_sync();
    }
    if (tile_id(nt - 1, nt - 1) % C == rank) {
        for (int e = tid; e < TILE; e += THREADS) {
            mine(nt - 1, nt - 1)[e] = Lw[e];
        }
    }
    if (tid == 0) ok_sh = ok;
    cluster_sync();
    if (rank == 0) chol::backward<THREADS>(at, bv, inv, nt);
    cluster_sync();
    if (rank != 0) return;
    const bool solved = ok_sh != 0;
    for (int i = tid; i < D; i += THREADS) {
        const double x = bv[i];
        dx[i] = ((solved && isfinite(x)) ? (float)x : 0.0f) * free_mask[i];
        out[i] = dx[i];
    }
    __syncthreads();
    retract(dx, free_mask, D, v, out + D);
}

// the one-block path's dynamic shared memory: the rhs and inverse pivots
// (float64), the step (float32), nt 16 entries each, and the tiles
size_t block_bytes(int nt) {
    return (size_t)nt * NB * (8 + 8 + 4) +
           sizeof(double) * chol::tile_doubles(nt);
}
// the cluster path's, a CTA: its share of the tiles (kDsmem), its copy of
// L_jj, the inverse pivots and CTA 0's rhs (float64), CTA 0's step
// (float32)
size_t cluster_bytes(int nt, bool dsmem) {
    const size_t slots = (tile_id(nt, 0) + CLUSTER - 1) / CLUSTER;
    return sizeof(double) * ((dsmem ? slots : 0) + 1) * TILE +
           (size_t)nt * NB * (8 + 8 + 4);
}

// raise a kernel's dynamic shared memory limit once a process
template <typename K>
cudaError_t smem_for(K kernel, size_t bytes, size_t& set) {
    if (bytes > set) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        set = bytes;
    }
    return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Whether the cluster path with its tiles in distributed shared memory
// (kDsmem) or in global scratch fits the card at nt (the attributes set on
// the way, once a process; 16 is a non-portable cluster size)
template <bool kDsmem>
bool cluster_fits(int nt) {
    const size_t smem = cluster_bytes(nt, kDsmem);
    if (smem > SHARED_MAX) return false;
    static size_t set = 0;
    if (smem_for(ba_solve_cluster<kDsmem>, smem, set) != cudaSuccess) {
        return false;
    }
    if (cudaFuncSetAttribute(ba_solve_cluster<kDsmem>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
        return false;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(smem, nullptr, attr);
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, ba_solve_cluster<kDsmem>,
                                          &cfg) == cudaSuccess &&
           n >= 1;
}

// K26's path for D: 0 one block; 1 the cluster, tiles in distributed
// shared memory; 2 the cluster, tiles in global scratch; -1 none fits
int path_of(int D) {
    const int nt = (D + NB - 1) / NB;
    if (block_bytes(nt) <= SHARED_MAX) return 0;
    static int known[256] = {};  // the path + 2 an nt, once a process
    if (nt < 256 && known[nt] != 0) return known[nt] - 2;
    const int path = cluster_fits<true>(nt)    ? 1
                     : cluster_fits<false>(nt) ? 2
                                               : -1;
    if (nt < 256) known[nt] = path + 2;
    return path;
}

}  // namespace

// Float64 entries of the scratch K26 needs for D: 0 unless its tiles fit
// neither one block's shared memory nor the cluster's.
VSG_API long long vsg_ba_solve_scratch(int D) {
    const int nt = (D + NB - 1) / NB;
    const long long slots = (tile_id(nt, 0) + CLUSTER - 1) / CLUSTER;
    return path_of(D) == 2 ? CLUSTER * slots * TILE : 0;
}

// S (D, D) f32 (symmetric; its lower triangle is read), rhs (D,) f32,
// free_mask (D,) f32 of 0 / 1 (a variable's rows all alike), lam the
// Levenberg damping; D = 6 L + 3 P + 3 R + 6 Dn.  poses (L, 7), planes
// (P, 4), rooms (R, 3), doors (Dn, 7) f32 (null where the count is 0).
// out: D floats of dx, then the moved poses, planes, rooms and doors in
// that order.  scratch: vsg_ba_solve_scratch(D) doubles (null when 0).
VSG_API int vsg_ba_solve(const float* S, const float* rhs,
                         const float* free_mask, int D, double lam,
                         const float* poses, int L, const float* planes,
                         int P, const float* rooms, int R, const float* doors,
                         int Dn, float* out, double* scratch,
                         cudaStream_t stream) {
    if (D != 6 * L + 3 * P + 3 * R + 6 * Dn || D < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const Vars v{poses, planes, rooms, doors, L, P, R, Dn};
    const int nt = (D + NB - 1) / NB;
    const int path = path_of(D);
    if (path < 0) return (int)cudaErrorNotSupported;
    if (path == 2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (path == 0) {
        const size_t smem = block_bytes(nt);
        static size_t set = 0;
        err = smem_for(ba_solve_block, smem, set);
        if (err != cudaSuccess) return (int)err;
        ba_solve_block<<<1, THREADS, smem, stream>>>(S, rhs, free_mask, D,
                                                     lam, v, out);
    } else {
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t cfg =
            cluster_config(cluster_bytes(nt, path == 1), stream, attr);
        err = path == 1
                  ? cudaLaunchKernelEx(&cfg, ba_solve_cluster<true>, S, rhs,
                                       free_mask, D, lam, v, out, scratch)
                  : cudaLaunchKernelEx(&cfg, ba_solve_cluster<false>, S,
                                       rhs, free_mask, D, lam, v, out,
                                       scratch);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
