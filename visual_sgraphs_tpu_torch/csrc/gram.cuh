// The landmark Gram reduction shared by K8 (schur.cu) and K22a
// (lm_reproj.cu): per landmark n, the 3 x 6L block B_n (zero outside the
// window slots that observe n) and its per-slot terms, summed over the
// landmarks into the pair sums sum_n B_n^T B_n and the per-slot vectors,
// without atomics and in an order fixed by the data alone.
//
// - Landmarks.  CTA c of G takes the landmarks c, c + G, c + 2G, ... (so
//   a window's observed landmarks, packed at the front of its table,
//   spread over every CTA); one thread a landmark writes the outputs of
//   those with no observation and lists the others, in order (``own``).
// - Staging.  A segment of SEG lanes (8, 16 or 32: 32 / SEG landmarks a
//   warp) builds one listed landmark's terms in its own area of shared
//   memory (``Stage``): its rows or observations one a lane, SEG at a
//   time; the rows of one slot collapsed by ``__match_any_sync`` into the
//   first of them (later ones added in lane order), so a staged landmark
//   holds one entry q a distinct slot: P_q (3 x 6), B_q, the slot's 6 x 6
//   block (21 upper entries) and two 6-vectors.
// - Accumulation.  A CTA has 576 threads, 16 groups of 36: thread t owns
//   entry (i, j) = ((t % 36) / 6, t % 6) of every 6 x 6 slot-pair block
//   p = t / 36 (mod 16) of the upper triangle, and of every per-slot block.
//   For each staged landmark, in list order, it adds its entries'
//   products, skipping slot pairs the landmark does not observe.  The
//   products are symmetric in (i, j) <-> (j, i), so a mirrored lower
//   triangle is exact.
// - Cross-CTA sums (``reduce``).  Clusters of 8 CTAs (no more clusters
//   than are resident at once): CTA rank r sums slice r of the entries
//   over its cluster's CTAs through distributed shared memory (rank order,
//   float64) into a scratch row; the last cluster to finish slice r (a
//   ticket a slice) sums the rows in cluster order and writes the outputs.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace gram {

namespace cg = cooperative_groups;

constexpr int GROUPS = 16;
constexpr int THREADS = 36 * GROUPS;  // 576: 18 warps
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;
constexpr int MAX_CLUSTERS = 16;
constexpr unsigned FULL = 0xffffffffu;

// a staged (landmark, slot) entry: P (3 x 6) | B (3 x 6) | the slot's 6 x 6
// block (21 upper entries) | rhs (6) | g (6)
constexpr int Q_P = 0, Q_B = 18, Q_H = 36, Q_R = 57, Q_G = 63, QS = 69;
// the values a row contributes before collapsing: P | block | g
constexpr int NV = 45;

__host__ __device__ __forceinline__ int n_pairs(int L) {
    return L * (L + 1) / 2;
}

// words of one segment's stage: header (nq, cost), slot -> q map, q ->
// slot, the staged entries
__host__ __device__ __forceinline__ int stage_words(int L, int Qmax) {
    return 4 + L + Qmax + Qmax * QS;
}

// index of entry (i, j) among a symmetric 6 x 6 block's 21 upper entries
__host__ __device__ __forceinline__ int tri6(int i, int j) {
    const int a = i < j ? i : j, b = i < j ? j : i;
    return 6 * a - a * (a - 1) / 2 + (b - a);
}

// the lanes of ``lane``'s segment
template <int SEG>
__device__ __forceinline__ unsigned seg_mask(int lane) {
    return SEG == 32 ? FULL : ((1u << SEG) - 1u) << (lane & ~(SEG - 1));
}

// Sum over a segment (every lane of the warp calls it; each gets its
// segment's sum, the same bits in every lane of it).
template <int SEG>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(FULL, v, off);
    }
    return v;
}

template <int SEG>
__device__ __forceinline__ double seg_sum(double v) {
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(FULL, v, off);
    }
    return v;
}

struct Stage {
    int* hdr;    // [0] entries nq, [1] cost (float bits)
    int* map;    // (L,) slot -> q, -1 when unobserved
    int* qslot;  // (Qmax,) q -> slot
    float* q;    // (Qmax, QS)
};

__device__ __forceinline__ Stage stage_at(int* base, int L, int Qmax) {
    Stage s;
    s.hdr = base;
    s.map = base + 4;
    s.qslot = s.map + L;
    s.q = reinterpret_cast<float*>(s.qslot + Qmax);
    return s;
}

template <int SEG>
__device__ __forceinline__ void stage_reset(Stage st, int L, int lane) {
    for (int s = lane % SEG; s < L; s += SEG) st.map[s] = -1;
    __syncwarp();
}

// One chunk of a landmark's rows (a lane each, every lane of the warp
// calling): lane's slot k (used when ok) and its values v = [P (18) |
// block (21) | g (6)].  Rows of one slot collapse into the first of them,
// later rows added in lane order; a slot already staged by an earlier
// chunk adds to its entry.  ``nq`` (segment uniform) counts the entries.
template <int SEG>
__device__ __forceinline__ void stage_chunk(Stage st, bool ok, int k,
                                            float (&v)[NV], int lane,
                                            int& nq) {
    const int key = ok ? k + (lane / SEG) * 65536 : -1 - lane;
    const unsigned grp = __match_any_sync(FULL, key);
    const int leader = __ffs(grp) - 1;
    unsigned dup = __ballot_sync(FULL, ok && lane != leader);
    while (dup) {
        const int j = __ffs(dup) - 1;
        dup &= dup - 1;
        const int lj = __shfl_sync(FULL, leader, j);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
            const float x = __shfl_sync(FULL, v[t], j);
            if (lane == lj) v[t] += x;
        }
    }
    const bool lead = ok && lane == leader;
    const bool seen = lead && st.map[k] >= 0;
    const unsigned fresh =
        __ballot_sync(FULL, lead && !seen) & seg_mask<SEG>(lane);
    if (lead) {
        int q;
        if (seen) {
            q = st.map[k];
        } else {
            q = nq + __popc(fresh & ((1u << lane) - 1u));
            st.map[k] = q;
            st.qslot[q] = k;
        }
        float* d = st.q + q * QS;
#pragma unroll
        for (int t = 0; t < 18; ++t) d[Q_P + t] = seen ? d[Q_P + t] + v[t] : v[t];
#pragma unroll
        for (int t = 0; t < 21; ++t) {
            d[Q_H + t] = seen ? d[Q_H + t] + v[18 + t] : v[18 + t];
        }
#pragma unroll
        for (int t = 0; t < 6; ++t) {
            d[Q_G + t] = seen ? d[Q_G + t] + v[39 + t] : v[39 + t];
        }
    }
    nq += __popc(fresh);
    __syncwarp();
}

// The staged landmarks 0 .. nst - 1, in order, added to the thread's pair
// entries acc[36 p + e] (p = g, g + 16, ...); term(entry of s, entry of t,
// s == t) is a landmark's addend, skipped where it does not observe both
// slots.  P > 0: exactly P owned pairs, their sums in registers and a
// landmark's slot lookups issued together; P = 0: any number, a pair at a
// time.
template <int P, class Term>
__device__ __forceinline__ void add_pairs(float* acc, const int* ptab,
                                          int Lp, int g, int e,
                                          const int* stage0, int sw, int L,
                                          int Qmax, int nst, Term term) {
    if constexpr (P > 0) {
        constexpr int NP = P;
        int ps[NP], pt[NP];
        float sum[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int p = g + GROUPS * k;
            const bool on = p < Lp;
            ps[k] = on ? ptab[p] >> 16 : -1;
            pt[k] = on ? ptab[p] & 0xffff : 0;
            sum[k] = on ? acc[36 * p + e] : 0.0f;
        }
        for (int w = 0; w < nst; ++w) {
            const int* map = stage0 + w * sw + 4;
            const float* q = reinterpret_cast<const float*>(map + L + Qmax);
            int qs[NP], qt[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k) {
                qs[k] = ps[k] >= 0 ? map[ps[k]] : -1;
                qt[k] = map[pt[k]];
            }
#pragma unroll
            for (int k = 0; k < NP; ++k) {
                if ((qs[k] | qt[k]) >= 0) {
                    sum[k] += term(q + qs[k] * QS, q + qt[k] * QS,
                                   ps[k] == pt[k]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            if (ps[k] >= 0) acc[36 * (g + GROUPS * k) + e] = sum[k];
        }
    } else {
        for (int p = g; p < Lp; p += GROUPS) {
            const int s = ptab[p] >> 16, t = ptab[p] & 0xffff;
            float sum = acc[36 * p + e];
            for (int w = 0; w < nst; ++w) {
                const int* map = stage0 + w * sw + 4;
                const int qs = map[s], qt = map[t];
                if ((qs | qt) < 0) continue;
                const float* q =
                    reinterpret_cast<const float*>(map + L + Qmax);
                sum += term(q + qs * QS, q + qt * QS, s == t);
            }
            acc[36 * p + e] = sum;
        }
    }
}

// Packed lower inverse Cholesky factor [i00, i10, i11, i20, i21, i22] of
// the 3 x 3 block h (upper 6: h00 h01 h02 h11 h12 h22) whose diagonal is
// damped by d0, d1, d2.
__device__ __forceinline__ void chol_inv3(const float* h, float d0, float d1,
                                          float d2, float* li) {
    const float l00 = sqrtf(h[0] + d0);
    const float l10 = h[1] / l00, l20 = h[2] / l00;
    const float l11 = sqrtf(h[3] + d1 - l10 * l10);
    const float l21 = (h[4] - l20 * l10) / l11;
    const float l22 = sqrtf(h[5] + d2 - l20 * l20 - l21 * l21);
    const float i00 = 1.0f / l00, i11 = 1.0f / l11, i22 = 1.0f / l22;
    li[0] = i00;
    li[1] = -l10 * i00 * i11;
    li[2] = i11;
    li[4] = -l21 * i11 * i22;
    li[3] = -(l20 * i00 + l21 * li[1]) * i22;
    li[5] = i22;
}

// B_q = Linv P_q for every staged entry, a (q, column) a lane of the
// segment.
template <int SEG>
__device__ __forceinline__ void stage_b(Stage st, int nq, const float* li,
                                        int lane) {
    for (int t = lane % SEG; t < nq * 6; t += SEG) {
        float* d = st.q + (t / 6) * QS;
        const int j = t % 6;
        const float p0 = d[Q_P + j], p1 = d[Q_P + 6 + j],
                    p2 = d[Q_P + 12 + j];
        d[Q_B + j] = li[0] * p0;
        d[Q_B + 6 + j] = li[1] * p0 + li[2] * p1;
        d[Q_B + 12 + j] = li[3] * p0 + li[4] * p1 + li[5] * p2;
    }
    __syncwarp();
}

// The (s, t) of the upper-triangle slot pairs, row by row, packed s << 16
// | t, into tab (n_pairs(L),).
__device__ __forceinline__ void pair_table(int* tab, int L) {
    for (int p = threadIdx.x; p < n_pairs(L); p += blockDim.x) {
        int s = 0, r = p;
        while (r >= L - s) {
            r -= L - s;
            ++s;
        }
        tab[p] = (s << 16) | (s + r);
    }
}

// The landmarks of this CTA in order (``sel(j)``: its j-th of ``count``;
// ascending), those for which ``busy(lm)`` holds listed into ``list``;
// the others handed to ``idle(lm)`` (one thread each).  Returns the
// listed count.  ``warp_tot``: WARPS ints of shared scratch.
template <class Sel, class Busy, class Idle>
__device__ int own(int count, Sel sel, Busy busy, Idle idle, int* list,
                   int* warp_tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int total = 0;
    for (int j0 = 0; j0 < count; j0 += THREADS) {
        const int j = j0 + (int)threadIdx.x;
        const int lm = j < count ? sel(j) : -1;
        const bool b = lm >= 0 && busy(lm);
        if (lm >= 0 && !b) idle(lm);
        const unsigned bits = __ballot_sync(FULL, b);
        if (lane == 0) warp_tot[warp] = __popc(bits);
        __syncthreads();
        int before = total;
        for (int w = 0; w < warp; ++w) before += warp_tot[w];
        if (b) list[before + __popc(bits & ((1u << lane) - 1u))] = lm;
        for (int w = 0; w < WARPS; ++w) total += warp_tot[w];
        __syncthreads();
    }
    return total;
}

// The CTAs' partials acc (E floats in each CTA's shared memory) summed in a
// fixed order (see the header); write(e, value) is called once for every
// entry e, by the CTA that finishes it.  part: (clusters, E) f64 scratch;
// tickets: CLUSTER counters, zero between launches.
template <class Write>
__device__ void reduce(const float* acc, int E, double* part,
                       unsigned* tickets, Write write) {
    __shared__ int last;
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
    const int ncl = gridDim.x / C, cid = blockIdx.x / C;
    const int lo = (int)((long long)E * r / C);
    const int hi = (int)((long long)E * (r + 1) / C);
    cl.sync();
    for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
        double v = 0.0;
#pragma unroll
        for (int k = 0; k < CLUSTER; ++k) {
            v += (double)cl.map_shared_rank(acc, k)[e];
        }
        part[(size_t)cid * E + e] = v;
    }
    __threadfence();
    cl.sync();
    if (threadIdx.x == 0) {
        last = atomicAdd(&tickets[r], 1u) == (unsigned)(ncl - 1);
        if (last) atomicExch(&tickets[r], 0u);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
        // every cluster's row loaded at once, then summed in order
        double rows[MAX_CLUSTERS];
#pragma unroll
        for (int c = 0; c < MAX_CLUSTERS; ++c) {
            rows[c] = c < ncl ? __ldcg(&part[(size_t)c * E + e]) : 0.0;
        }
        double v = 0.0;
#pragma unroll
        for (int c = 0; c < MAX_CLUSTERS; ++c) {
            if (c < ncl) v += rows[c];
        }
        write(e, v);
    }
}

// Host: clusters of CLUSTER CTAs of ``kernel`` with ``smem`` bytes that
// are resident at once (at least 1).
template <class Kernel>
int max_clusters(Kernel kernel, size_t smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER * MAX_CLUSTERS, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess
        || cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();
        return 1;
    }
    return n < 1 ? 1 : n;
}

// Host: launch ``kernel`` as ``clusters`` clusters of CLUSTER CTAs.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int clusters, size_t smem,
                   cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CLUSTER, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Host: the segment width for rows of up to ``rows`` lanes.
inline int seg_for(int rows) { return rows <= 8 ? 8 : rows <= 16 ? 16 : 32; }

}  // namespace gram
