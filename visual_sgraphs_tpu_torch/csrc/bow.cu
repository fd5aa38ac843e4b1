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
// ::detect_candidates and ::best_covisible_score as the keyframe program
// runs them (loop_closer.py::_detect_program).  Bound: bytes, the (Kmax, W)
// float32 rows and bool occupancy (128 x 512 on this path, 320 KB), read
// once.  Design: one block per database row reduces sum_w min(q, bow) and
// the common-word count over W; one final thread applies the validity
// and exclusion masks, the min_common_ratio gate (float32 product
// truncated to int, as the reference), the top-n with lower indices
// first among equal scores (lax.top_k), the best covisible score and the
// valid-row count, and writes the packed scalars.
#include "common.cuh"

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

__global__ void place_scores_kernel(const float* __restrict__ bow,
                                    const uint8_t* __restrict__ has_word,
                                    const float* __restrict__ q, int W,
                                    float* __restrict__ scores,
                                    int* __restrict__ common) {
    __shared__ float scratch[32];
    __shared__ int iscratch[32];
    const int k = blockIdx.x;
    float s = 0.0f;
    int c = 0;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
        const float qw = q[w];
        s += fminf(qw, bow[(size_t)k * W + w]);
        c += (has_word[(size_t)k * W + w] != 0 && qw > 0.0f) ? 1 : 0;
    }
    const float total = block_sum_f(s, scratch);
    for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) iscratch[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        int ct = 0;
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) ct += iscratch[i];
        scores[k] = total;
        common[k] = ct;
    }
}

__global__ void place_select_kernel(const float* __restrict__ scores,
                                    const int* __restrict__ common,
                                    const uint8_t* __restrict__ valid,
                                    const uint8_t* __restrict__ exclude,
                                    const uint8_t* __restrict__ covis, int K,
                                    float ratio, int top_n,
                                    float* __restrict__ packed) {
    if (threadIdx.x != 0) return;
    int max_common = 0;
    for (int k = 0; k < K; ++k) {
        if (valid[k] && !exclude[k]) max_common = max(max_common, common[k]);
    }
    const int thr = max((int)__fmul_rn(ratio, (float)max_common), 1);
    float ts[8];
    int ti[8];
    for (int i = 0; i < top_n; ++i) {
        ts[i] = -INFINITY;
        ti[i] = 0;
    }
    float ref = 0.0f;
    int n_valid = 0;
    for (int k = 0; k < K; ++k) {
        const float l1 = valid[k] ? scores[k] : 0.0f;
        const int cm = (valid[k] && !exclude[k]) ? common[k] : 0;
        const float sc = cm >= thr ? l1 : 0.0f;
        if (covis[k]) ref = fmaxf(ref, l1);
        n_valid += valid[k] ? 1 : 0;
        // strict comparison: an equal later score never displaces an
        // earlier one (lower index first)
        int pos = top_n;
        for (int i = top_n - 1; i >= 0 && sc > ts[i]; --i) pos = i;
        if (pos < top_n) {
            for (int i = top_n - 1; i > pos; --i) {
                ts[i] = ts[i - 1];
                ti[i] = ti[i - 1];
            }
            ts[pos] = sc;
            ti[pos] = k;
        }
    }
    packed[0] = ref;
    for (int i = 0; i < top_n; ++i) {
        packed[1 + i] = ts[i] > 0.0f ? (float)ti[i] : -1.0f;
        packed[1 + top_n + i] = ts[i];
    }
    packed[1 + 2 * top_n] = (float)n_valid;
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
// q: (W,) f32; scratch scores (K,) f32 and common (K,) i32.  Output packed
// (2 top_n + 2,) f32: [best covisible score, ids (-1 = none), scores,
// valid rows].
VSG_API int vsg_place_query(const float* bow, const uint8_t* has_word,
                            const uint8_t* valid, const float* q,
                            const uint8_t* exclude, const uint8_t* covis,
                            int K, int W, float ratio, int top_n,
                            float* scores, int* common, float* packed,
                            cudaStream_t stream) {
    if (K == 0) return 0;
    place_scores_kernel<<<K, 128, 0, stream>>>(bow, has_word, q, W, scores,
                                               common);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    place_select_kernel<<<1, 32, 0, stream>>>(scores, common, valid, exclude,
                                              covis, K, ratio, top_n, packed);
    return (int)cudaGetLastError();
}
