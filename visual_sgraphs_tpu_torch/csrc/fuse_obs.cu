// K28: fuse_observations' bookkeeping around the tracking pass, two
// entries.
//
// Replaces what visual_sgraphs_tpu/slam/mapping.py:525 fuse_observations
// computes before and after its projection and window match (which the
// port runs as K5's tracking pass, track_pass.cu):
// - vsg_fuse_prologue (mapping.py:532-540, 548): keyframe kf's
//   covisibility counts over every keyframe (slam/map_state.py:272: the
//   valid points kf observes, shared with each valid keyframe's row, 0 at
//   kf), their top 8 with lax.top_k's order (higher count first, the
//   lower slot on a tie), the mask counts > 0, the valid points those 8
//   rows observe compacted to n_local int32 ids (K7's observed entry,
//   compact.cuh) and kf's free keypoints (kp_valid & kf_obs_pt < 0).  The
//   port ran this as ~25 eager operations (covisibility_counts,
//   topk_stable, the masks) around a K7 launch.
// - vsg_fuse_writeback (mapping.py:556-560): row kf of a new kf_obs_pt,
//   the scatter-max of the matched ids into the old row (unmatched
//   entries max -1 into the dump slot F - 1, as the reference), every
//   other row copied (the map is not modified).  Integer maxima: exact,
//   independent of their order.
//
// What bounds it here: latency.  The prologue reads the (K, F) = (128,
// 1000) observation ids and keypoint flags once (~640 KB) and N bytes of
// pt_valid; the write-back copies kf_obs_pt (512 KB) and reads the
// pass's n_local matches.
//
// Design: the prologue is one cluster of 8 CTAs of 1024 threads.  Every
// CTA builds the bitmap of kf's valid points in shared memory (N / 8
// bytes) and counts 1/8 of the rows against it (shared atomics), writing
// each row's count into CTA 0 through distributed shared memory; after
// one cluster barrier CTA 0 ranks the K counts (a thread a keyframe: its
// rank is the number of counts before it in the stable order) and runs
// K7's observed pass over the 8 winners in the same launch.  The
// write-back is one CTA a row: row kf staged in shared memory and maxed
// by shared atomics, the others copied.
#include <cooperative_groups.h>

#include "common.cuh"
#include "compact.cuh"
#include "map_maint.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int TOP = 8;
constexpr int ROW_THREADS = 256;

template <int WPT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
fuse_prologue_kernel(const int* __restrict__ obs,
                     const uint8_t* __restrict__ kp_valid,
                     const uint8_t* __restrict__ kf_valid,
                     const uint8_t* __restrict__ pt_valid, int K, int F,
                     int N, int kf, int size, int* __restrict__ ids_out,
                     uint8_t* __restrict__ free_out) {
    // member bitmap (n_words), then K7's bitmap and staged ids (CTA 0),
    // then the K counts (CTA 0)
    extern __shared__ uint32_t sh[];
    const int n_words = (N + 31) >> 5;
    uint32_t* member = sh;
    uint32_t* k7 = member + n_words;
    int* counts = reinterpret_cast<int*>(k7 + n_words + size);
    __shared__ int row_cnt[128];
    __shared__ long long top[TOP];
    __shared__ uint8_t top_mask[TOP];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;
    const int per = (K + CLUSTER - 1) / CLUSTER;
    const int r0 = min(K, rank * per), r1 = min(K, r0 + per);

    for (int w = tid; w < n_words; w += THREADS) member[w] = 0u;
    for (int r = tid; r < per; r += THREADS) row_cnt[r] = 0;
    __syncthreads();
    mm_mark_row(obs + (long long)kf * F, kp_valid + (long long)kf * F, F, N,
                member);
    __syncthreads();
    const bool vec = ((uintptr_t)pt_valid & 15) == 0;
    for (int w = tid; w < n_words; w += THREADS) {
        member[w] &= load_word(pt_valid, N, w, vec);
    }
    __syncthreads();
    mm_covis_rows(obs, kp_valid, F, N, r0, r1, member, row_cnt);
    __syncthreads();
    int* counts0 = cluster.map_shared_rank(counts, 0);
    for (int r = r0 + tid; r < r1; r += THREADS) {
        counts0[r] = (kf_valid[r] && r != kf) ? row_cnt[r - r0] : 0;
    }
    mm_cluster_sync();
    if (rank != 0) return;

    // the stable top 8: a keyframe's rank is the number of keyframes with
    // a higher count, or an equal count and a lower slot
    for (int r = tid; r < K; r += THREADS) {
        const int c = counts[r];
        int before = 0;
        for (int j = 0; j < K; ++j) {
            const int cj = counts[j];
            before += (cj > c || (cj == c && j < r)) ? 1 : 0;
        }
        if (before < TOP) {
            top[before] = r;
            top_mask[before] = c > 0;
        }
    }
    const long long row = (long long)kf * F;
    for (int f = tid; f < F; f += THREADS) {
        free_out[f] = kp_valid[row + f] && obs[row + f] < 0;
    }
    __syncthreads();
    compact_observed_block<WPT>(obs, kp_valid, K, F, top, top_mask, TOP,
                                pt_valid, N, size, 1, ids_out, k7);
}

__global__ void __launch_bounds__(ROW_THREADS)
fuse_writeback_kernel(const int* __restrict__ obs, int F, int kf,
                      const uint8_t* __restrict__ ok,
                      const long long* __restrict__ slot,
                      const int* __restrict__ ids, int n,
                      int* __restrict__ out) {
    extern __shared__ int row[];
    const long long base = (long long)blockIdx.x * F;
    const int tid = threadIdx.x;
    if ((int)blockIdx.x != kf) {
        if ((F & 3) == 0 && ((uintptr_t)obs & 15) == 0 &&
            ((uintptr_t)out & 15) == 0) {
            const int4* s = reinterpret_cast<const int4*>(obs + base);
            int4* o = reinterpret_cast<int4*>(out + base);
            for (int j = tid; j < F / 4; j += ROW_THREADS) o[j] = __ldg(s + j);
        } else {
            for (int j = tid; j < F; j += ROW_THREADS) {
                out[base + j] = obs[base + j];
            }
        }
        return;
    }
    for (int j = tid; j < F; j += ROW_THREADS) row[j] = obs[base + j];
    __syncthreads();
    for (int e = tid; e < n; e += ROW_THREADS) {
        if (ok[e]) {
            const long long s = slot[e];
            if (s >= 0 && s < F) atomicMax(row + s, ids[e]);
        } else {
            atomicMax(row + F - 1, -1);
        }
    }
    __syncthreads();
    for (int j = tid; j < F; j += ROW_THREADS) out[base + j] = row[j];
}

template <typename Kern>
cudaError_t smem_for(Kern kern, size_t bytes, size_t& set) {
    if (bytes > 48 * 1024 && bytes > set) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return e;
        set = bytes;
    }
    return cudaSuccess;
}

template <int WPT>
int launch_prologue(const int* obs, const uint8_t* kp_valid,
                    const uint8_t* kf_valid, const uint8_t* pt_valid, int K,
                    int F, int N, int kf, int size, int* ids_out,
                    uint8_t* free_out, cudaStream_t stream) {
    const int n_words = (N + 31) >> 5;
    const size_t smem = 4 * (2 * (size_t)n_words + size + K);
    static size_t set = 0;
    const cudaError_t e = smem_for(fuse_prologue_kernel<WPT>, smem, set);
    if (e != cudaSuccess) return (int)e;
    fuse_prologue_kernel<WPT><<<CLUSTER, THREADS, smem, stream>>>(
        obs, kp_valid, kf_valid, pt_valid, K, F, N, kf, size, ids_out,
        free_out);
    return (int)cudaGetLastError();
}

}  // namespace

#define VSG_WPT_CASES(X) X(1) X(2) X(4) X(8) X(16) X(32) X(64)

// obs: (K, F) i32 kf_obs_pt; kp_valid: (K, F) bool; kf_valid: (K,) bool;
// pt_valid: (N,) bool; kf: the keyframe; size: n_local; wpt:
// compact_plan(N, size).wpt -> ids_out (size,) i32, free_out (F,) bool
VSG_API int vsg_fuse_prologue(const int* obs, const uint8_t* kp_valid,
                              const uint8_t* kf_valid,
                              const uint8_t* pt_valid, int K, int F, int N,
                              int kf, int size, int wpt, int* ids_out,
                              uint8_t* free_out, cudaStream_t stream) {
    if (K < TOP || K > 128 * CLUSTER || kf < 0 || kf >= K || size <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    switch (wpt) {
#define VSG_CASE(W)                                                         \
    case W:                                                                 \
        return launch_prologue<W>(obs, kp_valid, kf_valid, pt_valid, K, F, \
                                  N, kf, size, ids_out, free_out, stream);
        VSG_WPT_CASES(VSG_CASE)
#undef VSG_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// obs: (K, F) i32 kf_obs_pt; kf: the keyframe; ok (n,) bool, slot (n,)
// i64, ids (n,) i32: the tracking pass's matches of the candidates ->
// out (K, F) i32
VSG_API int vsg_fuse_writeback(const int* obs, int K, int F, int kf,
                               const uint8_t* ok, const long long* slot,
                               const int* ids, int n, int* out,
                               cudaStream_t stream) {
    if (kf < 0 || kf >= K || F <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(int) * (size_t)F;
    static size_t set = 0;
    const cudaError_t e = smem_for(fuse_writeback_kernel, smem, set);
    if (e != cudaSuccess) return (int)e;
    fuse_writeback_kernel<<<K, ROW_THREADS, smem, stream>>>(
        obs, F, kf, ok, slot, ids, n, out);
    return (int)cudaGetLastError();
}
