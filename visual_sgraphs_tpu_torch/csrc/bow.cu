// K10: vocabulary-tree descent + tf-idf BoW rows, and K11: the place
// database query.
//
// K10 replaces visual_sgraphs_tpu/place/vocab.py::descend and ::bow_vector
// (vmapped over keyframes for the backfill, loop_closer.py::_backfill_bow).
// The JAX version gathers every descriptor's K children per level into an
// (N, K, 32) tensor, popcounts it and takes the argmin, then scatter-adds
// the tf row.
//
// What bounds it here: integer operations.  R x F descriptors (1 x 1000
// per keyframe, 128 x 1000 at the backfill) walk L = 3 levels of K = 8
// children, 8 XOR + popcount pairs each (~2 x 10^5 per keyframe); the
// tree (585 centers, 18 KB) stays in L1.  A keyframe's call is
// launch-bound.
//
// Design: a group of K lanes (8 on this path, four descriptors a warp)
// walks one descriptor down the tree: lane c scores child c with __popc
// on 8 x u32, and the group's argmin (shuffles, the lower child on ties,
// as jnp.argmin) picks the next node.  The leaf's tf count is an integer
// atomicAdd, so it is exact.  A second launch, one block per row, forms
// tf x idf and its L1 norm (block reduction; only the summation order
// differs from the plain version).
//
// K11 replaces visual_sgraphs_tpu/place/database.py::l1_scores,
// ::detect_candidates and ::best_covisible_score, and around them the
// keyframe program's validity sync and insertion (::add_keyframe) as
// loop_closer.py::_detect_program runs them.  Bound: bytes, the (Kmax, W)
// float32 rows and bool occupancy (128 x 512 on this path, 320 KB), read
// once: ~0.1 us at the memory rate, so a call is latency-bound, and what
// costs is every dependent step (a serial select over the rows, or
// separate operations for the validity sync, insertion and packing).
//
// Design: one launch of one cluster of 8 CTAs of 16 warps, a warp a row
// (rows r, r + 128, ...).  The warp reads its row with 16-byte loads (a
// float4 of the BoW row, the query and the row's four occupancy bytes a
// lane; scalar loads when W is not a multiple of 4), sums min(q, bow) in
// lane order and a fixed shuffle tree (so the scores are bitwise equal
// from launch to launch and within BOW_TOL of the twin's sum), counts the
// common words, and its lane 0 writes (score, count, flags) into CTA 0's
// shared tables through distributed shared memory.  After the cluster
// barrier warp 0 of CTA 0 selects: max_common as a warp reduction, the
// min_common_ratio gate (float32 product truncated to int, then
// max(., 1), as the reference), the best covisible score and the valid
// count as reductions, and the top-n as n rounds of a warp arg-max over
// (score descending, index ascending), lax.top_k's order.  With an
// insertion (kf >= 0) the launch also ANDs the database's validity with
// the map's keyframe validity before it reads anything and writes row
// kf's BoW, occupancy (bow > 0) and valid bit in place: only the warp
// that owns a row reads or writes it, and it writes after its own reads,
// so the candidates, scores and valid count read the database before the
// insertion, as the reference does.  The best covisible score is read
// there too; the reference reads it after the insertion, which is the
// same value because covisibility_counts zeroes the keyframe's own entry
// (covis[kf] is false).  The launch writes the keyframe program's whole
// packed vector, the caller's extra scalars included.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROW_THREADS = 256;

struct LevelOffsets {
    int o[8];
};

__global__ void bow_words_kernel(const uint32_t* __restrict__ desc,
                                 const uint8_t* __restrict__ valid,
                                 const uint32_t* __restrict__ centers,
                                 LevelOffsets offs, int L, int K, int G,
                                 int W, int F, int n,
                                 int* __restrict__ tf,
                                 int* __restrict__ words) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int gid = t / G;
    const int c = t % G;
    const bool live = gid < n;
    uint32_t d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = live ? desc[8 * gid + k] : 0u;
    int node = 0;
    for (int l = 0; l < L; ++l) {
        int dist = 0x7fffffff;
        if (live && c < K) {
            const uint32_t* row = centers + 8 * (offs.o[l] + node * K + c);
            dist = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) dist += __popc(d[k] ^ row[k]);
        }
        int idx = c;
        for (int off = G >> 1; off > 0; off >>= 1) {
            const int od = __shfl_xor_sync(0xffffffffu, dist, off, G);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, off, G);
            if (od < dist || (od == dist && oi < idx)) {
                dist = od;
                idx = oi;
            }
        }
        node = node * K + idx;
    }
    if (live && c == 0) {
        words[gid] = node;
        if (valid[gid]) atomicAdd(&tf[(gid / F) * W + node], 1);
    }
}

__device__ float block_sum_f(float v, float* scratch) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = vsg_warp_sum(v);
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float s = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += scratch[i];
    __syncthreads();
    return s;
}

__global__ void bow_norm_kernel(const int* __restrict__ tf,
                                const float* __restrict__ idf, int W,
                                float* __restrict__ bow) {
    __shared__ float scratch[32];
    const int r = blockIdx.x;
    float s = 0.0f;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        s += __fmul_rn((float)tf[r * W + w], idf[w]);
    }
    const float total = fmaxf(block_sum_f(s, scratch), 1e-12f);
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        bow[r * W + w] = __fdiv_rn(__fmul_rn((float)tf[r * W + w], idf[w]),
                                   total);
    }
}

constexpr int PQ_CTAS = 8;  // the cluster
constexpr int PQ_WARPS = 16;  // a warp a row
constexpr int PQ_THREADS = 32 * PQ_WARPS;
constexpr int PQ_MAX_ROWS = 4096;  // CTA 0's gathered tables
constexpr int PQ_MAX_TOP = 8;
constexpr int PQ_UNROLL = 4;  // 16-byte chunks a lane loads at once
// gathered flags of a row
constexpr uint8_t PQ_VALID = 1, PQ_EXCLUDE = 2, PQ_COVIS = 4;

struct PlaceArgs {
    float* bow;  // (K, W); row kf written with an insertion
    uint8_t* has_word;  // (K, W)
    uint8_t* valid;  // (K,); synced and written with an insertion
    const float* q;  // (W,)
    const uint8_t* exclude;  // (K,)
    const uint8_t* covis;  // (K,)
    const uint8_t* kf_valid;  // (K,) or null (no validity sync)
    const int* extra;  // (n_extra,) int32, or null (zeros)
    float* packed;  // (2 top_n + 2 + n_extra,)
    int K, W, top_n, kf, n_extra;
    int vec;  // W % 4 == 0 and the rows 16-byte (occupancy 4-byte) aligned
    float ratio;
};

__device__ __forceinline__ void pq_cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void pq_cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// one row's sum_w min(q_w, bow_w) and common-word count, in every lane
// (the sum in lane order, then a fixed shuffle tree: lane 0's value is
// the same from launch to launch)
__device__ __forceinline__ void pq_row(const PlaceArgs& a, int r, int lane,
                                       float& score, int& common) {
    const float* row = a.bow + (size_t)r * a.W;
    const uint8_t* hw = a.has_word + (size_t)r * a.W;
    float s = 0.0f;
    int c = 0;
    if (a.vec) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* q4 = reinterpret_cast<const float4*>(a.q);
        const uint32_t* h4 = reinterpret_cast<const uint32_t*>(hw);
        const int n4 = a.W >> 2;
        // PQ_UNROLL chunks' loads in flight, then summed in chunk order
        for (int j0 = lane; j0 < n4; j0 += 32 * PQ_UNROLL) {
            float4 b[PQ_UNROLL], q[PQ_UNROLL];
            uint32_t h[PQ_UNROLL];
#pragma unroll
            for (int u = 0; u < PQ_UNROLL; ++u) {
                const int j = j0 + 32 * u;
                if (j < n4) {
                    b[u] = r4[j];
                    q[u] = __ldg(q4 + j);
                    h[u] = h4[j];
                }
            }
#pragma unroll
            for (int u = 0; u < PQ_UNROLL; ++u) {
                if (j0 + 32 * u >= n4) break;
                s += fminf(q[u].x, b[u].x);
                s += fminf(q[u].y, b[u].y);
                s += fminf(q[u].z, b[u].z);
                s += fminf(q[u].w, b[u].w);
                c += ((h[u] & 0xffu) != 0 && q[u].x > 0.0f) +
                     ((h[u] & 0xff00u) != 0 && q[u].y > 0.0f) +
                     ((h[u] & 0xff0000u) != 0 && q[u].z > 0.0f) +
                     ((h[u] >> 24) != 0 && q[u].w > 0.0f);
            }
        }
    } else {
        for (int w = lane; w < a.W; w += 32) {
            const float q = __ldg(a.q + w);
            s += fminf(q, row[w]);
            c += (hw[w] != 0 && q > 0.0f) ? 1 : 0;
        }
    }
    score = vsg_warp_sum(s);
    for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    common = c;
}

__global__ void __cluster_dims__(PQ_CTAS, 1, 1) __launch_bounds__(PQ_THREADS)
place_query_kernel(const __grid_constant__ PlaceArgs a) {
    // CTA 0's tables, written by every CTA's warps
    __shared__ float s_score[PQ_MAX_ROWS];
    __shared__ int s_common[PQ_MAX_ROWS];
    __shared__ uint8_t s_flags[PQ_MAX_ROWS];
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    pq_cluster_arrive();
    float* d_score = cl.map_shared_rank(s_score, 0);
    int* d_common = cl.map_shared_rank(s_common, 0);
    uint8_t* d_flags = cl.map_shared_rank(s_flags, 0);
    const bool insert = a.kf >= 0;
    bool waited = false;
    for (int r = rank * PQ_WARPS + warp; r < a.K;
         r += PQ_CTAS * PQ_WARPS) {
        const bool v = a.valid[r] != 0 &&
                       (a.kf_valid == nullptr || a.kf_valid[r] != 0);
        float score;
        int common;
        pq_row(a, r, lane, score, common);
        if (!waited) {
            // every CTA has started before the first remote write
            pq_cluster_wait();
            waited = true;
        }
        if (lane == 0) {
            d_score[r] = score;
            d_common[r] = common;
            d_flags[r] = (v ? PQ_VALID : 0) |
                         (a.exclude[r] ? PQ_EXCLUDE : 0) |
                         (a.covis[r] ? PQ_COVIS : 0);
            if (insert) a.valid[r] = (v || r == a.kf) ? 1 : 0;
        }
        if (r == a.kf) {
            // the insertion, after this warp's reads of the row
            __syncwarp();
            for (int w = lane; w < a.W; w += 32) {
                const float q = __ldg(a.q + w);
                a.bow[(size_t)r * a.W + w] = q;
                a.has_word[(size_t)r * a.W + w] = q > 0.0f ? 1 : 0;
            }
        }
    }
    if (!waited) pq_cluster_wait();
    // the tables are complete once every CTA has arrived again
    pq_cluster_arrive();
    pq_cluster_wait();
    if (rank != 0 || warp != 0) return;

    // ---- the select, warp 0 of CTA 0, lanes striding the rows; the
    // warp reductions in the redux unit (gated scores and the reference
    // score are >= 0, so their float bits order as unsigned integers)
    int mc = 0;
    for (int k = lane; k < a.K; k += 32) {
        if ((s_flags[k] & (PQ_VALID | PQ_EXCLUDE)) == PQ_VALID) {
            mc = max(mc, s_common[k]);
        }
    }
    mc = (int)__reduce_max_sync(0xffffffffu, (unsigned)mc);
    const int thr = max((int)__fmul_rn(a.ratio, (float)mc), 1);
    // each row's gated score (in place), the covisible maximum, the valid
    // count, and the lane's first best row
    float ref = 0.0f;
    int n_valid = 0;
    float bv = -1.0f;
    int bi = 0x7fffffff;
    for (int k = lane; k < a.K; k += 32) {
        const uint8_t f = s_flags[k];
        const float l1 = (f & PQ_VALID) ? s_score[k] : 0.0f;
        const int cm = (f & (PQ_VALID | PQ_EXCLUDE)) == PQ_VALID
                           ? s_common[k] : 0;
        const float sc = cm >= thr ? l1 : 0.0f;
        s_score[k] = sc;
        if (f & PQ_COVIS) ref = fmaxf(ref, l1);
        n_valid += (f & PQ_VALID) ? 1 : 0;
        if (sc > bv) {
            bv = sc;
            bi = k;
        }
    }
    ref = __uint_as_float(
        __reduce_max_sync(0xffffffffu, __float_as_uint(ref)));
    n_valid = (int)__reduce_add_sync(0xffffffffu, (unsigned)n_valid);
    // the top-n: a round takes the first best (score, index): the largest
    // score, then the least row among the lanes that hold it; its lane
    // rescans its rows without it (a taken row reads -1, below every
    // gated score; a lane without rows left holds -1 too)
    float* out = a.packed;
    for (int i = 0; i < a.top_n; ++i) {
        const unsigned key = bv < 0.0f ? 0u : __float_as_uint(bv) + 1u;
        const unsigned top = __reduce_max_sync(0xffffffffu, key);
        const int idx = (int)__reduce_min_sync(
            0xffffffffu, key == top ? (unsigned)bi : 0xffffffffu);
        const float v = __uint_as_float(top - 1u);
        if (lane == 0) {
            out[1 + i] = v > 0.0f ? (float)idx : -1.0f;
            out[1 + a.top_n + i] = v;
        }
        if ((idx & 31) == lane) {
            s_score[idx] = -1.0f;
            bv = -1.0f;
            bi = 0x7fffffff;
            for (int k = lane; k < a.K; k += 32) {
                if (s_score[k] > bv) {
                    bv = s_score[k];
                    bi = k;
                }
            }
        }
        __syncwarp();
    }
    if (lane == 0) {
        out[0] = ref;
        out[1 + 2 * a.top_n] = (float)n_valid;
    }
    for (int e = lane; e < a.n_extra; e += 32) {
        out[2 + 2 * a.top_n + e] =
            a.extra != nullptr ? (float)a.extra[e] : 0.0f;
    }
}

}  // namespace

// desc: (R*F, 32) u8 as (R*F, 8) u32; valid: (R*F,) u8; centers: every
// level's (K^(l+1), 32) table stacked, level l from row off_l; idf: (W,);
// tf: (R, W) i32 zero-filled by the caller.  Outputs words (R*F,) i32 and
// bow (R, W) f32.
VSG_API int vsg_bow_vectors(const uint32_t* desc, const uint8_t* valid,
                            const uint32_t* centers, int off0, int off1,
                            int off2, int off3, int off4, int off5, int off6,
                            int off7, int L, int K, int W, int R, int F,
                            const float* idf, int* tf, int* words, float* bow,
                            cudaStream_t stream) {
    const int n = R * F;
    if (n == 0) return 0;
    LevelOffsets offs = {{off0, off1, off2, off3, off4, off5, off6, off7}};
    int G = 1;
    while (G < K) G <<= 1;
    const int threads = 256;
    const long total = (long)n * G;
    const int blocks = (int)((total + threads - 1) / threads);
    bow_words_kernel<<<blocks, threads, 0, stream>>>(
        desc, valid, centers, offs, L, K, G, W, F, n, tf, words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bow_norm_kernel<<<R, ROW_THREADS, 0, stream>>>(tf, idf, W, bow);
    return (int)cudaGetLastError();
}

// bow: (K, W) f32, has_word: (K, W) u8, valid / exclude / covis: (K,) u8,
// q: (W,) f32; K <= 4096.  Output packed (2 top_n + 2 + n_extra,) f32:
// [best covisible score, ids (-1 = none), scores, valid rows, extra].
// With kf >= 0 (an insertion) valid is first ANDed with kf_valid (null:
// no sync), and row kf's bow, has_word (bow > 0) and valid bit are
// written in place after the query read them; extra: n_extra int32
// values, or null for zeros.  One launch.
VSG_API int vsg_place_query(float* bow, uint8_t* has_word, uint8_t* valid,
                            const float* q, const uint8_t* exclude,
                            const uint8_t* covis, const uint8_t* kf_valid,
                            int K, int W, float ratio, int top_n, int kf,
                            const int* extra, int n_extra, float* packed,
                            cudaStream_t stream) {
    if (K <= 0 || K > PQ_MAX_ROWS || top_n < 1 || top_n > PQ_MAX_TOP ||
        top_n > K || kf >= K) {
        return (int)cudaErrorInvalidValue;
    }
    PlaceArgs a;
    a.bow = bow;
    a.has_word = has_word;
    a.valid = valid;
    a.q = q;
    a.exclude = exclude;
    a.covis = covis;
    a.kf_valid = kf_valid;
    a.extra = extra;
    a.packed = packed;
    a.K = K;
    a.W = W;
    a.top_n = top_n;
    a.kf = kf;
    a.n_extra = n_extra;
    a.ratio = ratio;
    a.vec = (W & 3) == 0 &&
            (((uintptr_t)bow | (uintptr_t)q) & 15) == 0 &&
            ((uintptr_t)has_word & 3) == 0;
    place_query_kernel<<<PQ_CTAS, PQ_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}
