// K9: observation grouping, group_observations(obs_kf, obs_pt, uvr, valid,
// n_pt, max_obs).
//
// Replaces visual_sgraphs_tpu/parallel/dist_ba.py:60 group_observations:
// flat observation lists -> per-landmark (N, O) tables, each observation in
// its landmark's next free slot.  The slot is the observation's stable
// rank: how many earlier list entries share its landmark (invalid entries
// share the bucket n_pt).  Entries ranked >= max_obs are dropped and
// counted.  The reference (and the plain twin) sorts stably, searches the
// run starts and scatters three tables.
//
// What bounds it here: latency and memory bytes.  The local BA groups
// 11 x 1000 observations into (8192, 12) tables, the global BA 128 x 1000
// into (32768, 8); the outputs (~1.6 MB at the global BA) dominate the
// traffic.
//
// Design: a counting sort over the landmark-id range, stable by
// construction.  The list is cut into G contiguous segments, one warp
// each, walked in order 32 entries at a time: __match_any_sync finds the
// lanes that share a landmark, their rank in the step is the count of
// lower lanes among them, and the lowest of them carries the segment's
// per-landmark counter (a private row of a G x (n_pt + 2) table, so no
// atomics and no reordering).  A second kernel turns each landmark's
// counters into exclusive offsets over the segments, in segment order; a
// third adds the offset to each entry's in-segment rank and writes the kept
// entries (kf, the uvr bits, valid) at (landmark, rank).
//
// Precondition (every caller meets it): a valid entry's landmark lies in
// [0, n_pt).  Valid entries outside it are never kept; they share one
// extra bucket, so their ranks (and with them n_dropped) can differ from
// the twin's only if such entries exist.
#include "common.cuh"

namespace {

__device__ __forceinline__ int bucket_of(const int* obs_pt,
                                         const uint8_t* valid, int e,
                                         int n_pt) {
    if (!valid[e]) return n_pt;
    const int p = obs_pt[e];
    return (p >= 0 && p < n_pt) ? p : n_pt + 1;
}

__global__ void segment_rank_kernel(const int* __restrict__ obs_pt,
                                    const uint8_t* __restrict__ valid,
                                    int m, int n_pt, int seg_len,
                                    int* __restrict__ counts,
                                    int* __restrict__ local_rank) {
    const int g = blockIdx.x;
    const int lane = threadIdx.x;
    const int nb = n_pt + 2;
    int* cnt = counts + (size_t)g * nb;
    const int start = g * seg_len;
    const int end = min(start + seg_len, m);
    const unsigned lower = (1u << lane) - 1u;
    for (int s = start; s < end; s += 32) {
        const int e = s + lane;
        const bool act = e < end;
        const int key = act ? bucket_of(obs_pt, valid, e, n_pt) : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const int leader = __ffs(peers) - 1;
        int base = 0;
        if (act && lane == leader) base = cnt[key];
        base = __shfl_sync(0xffffffffu, base, leader);
        if (act) {
            local_rank[e] = base + __popc(peers & lower);
            if (lane == leader) cnt[key] = base + __popc(peers);
        }
        __syncwarp();
    }
}

__global__ void segment_offsets_kernel(int* __restrict__ counts, int G,
                                       int nb) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= nb) return;
    int run = 0;
    for (int g = 0; g < G; ++g) {
        const int c = counts[(size_t)g * nb + k];
        counts[(size_t)g * nb + k] = run;
        run += c;
    }
}

__global__ void scatter_kernel(const int* __restrict__ obs_kf,
                               const int* __restrict__ obs_pt,
                               const float* __restrict__ uvr,
                               const uint8_t* __restrict__ valid, int m,
                               int n_pt, int max_obs, int seg_len,
                               const int* __restrict__ counts,
                               const int* __restrict__ local_rank,
                               int* __restrict__ out_kf,
                               float* __restrict__ out_uvr,
                               uint8_t* __restrict__ out_valid,
                               int* __restrict__ n_dropped) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= m || !valid[e]) return;
    const int key = bucket_of(obs_pt, valid, e, n_pt);
    const int rank = local_rank[e] +
                     counts[(size_t)(e / seg_len) * (n_pt + 2) + key];
    if (rank >= max_obs) {
        atomicAdd(n_dropped, 1);
        return;
    }
    if (key >= n_pt) return;
    const size_t slot = (size_t)key * max_obs + rank;
    out_kf[slot] = obs_kf[e];
    out_uvr[3 * slot + 0] = uvr[3 * e + 0];
    out_uvr[3 * slot + 1] = uvr[3 * e + 1];
    out_uvr[3 * slot + 2] = uvr[3 * e + 2];
    out_valid[slot] = 1;
}

}  // namespace

// obs_kf, obs_pt: (m,) i32; uvr: (m, 3) f32; valid: (m,) bool.
// counts: (G, n_pt + 2) i32 zeroed, G = ceil(m / seg_len); local_rank: (m,)
// i32 scratch.  out_kf: (n_pt, max_obs) i32 filled with -1; out_uvr:
// (n_pt, max_obs, 3) f32 zeroed; out_valid: (n_pt, max_obs) bool zeroed;
// n_dropped: () i32 zeroed.
VSG_API int vsg_group_obs(const int* obs_kf, const int* obs_pt,
                          const float* uvr, const uint8_t* valid, int m,
                          int n_pt, int max_obs, int seg_len, int* counts,
                          int* local_rank, int* out_kf, float* out_uvr,
                          uint8_t* out_valid, int* n_dropped,
                          cudaStream_t stream) {
    if (m == 0) return 0;
    const int G = (m + seg_len - 1) / seg_len;
    const int nb = n_pt + 2;
    segment_rank_kernel<<<G, 32, 0, stream>>>(obs_pt, valid, m, n_pt,
                                              seg_len, counts, local_rank);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    segment_offsets_kernel<<<(nb + 255) / 256, 256, 0, stream>>>(counts, G,
                                                                 nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scatter_kernel<<<(m + 255) / 256, 256, 0, stream>>>(
        obs_kf, obs_pt, uvr, valid, m, n_pt, max_obs, seg_len, counts,
        local_rank, out_kf, out_uvr, out_valid, n_dropped);
    return (int)cudaGetLastError();
}
