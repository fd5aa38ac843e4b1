// Block routines of the keyframe program's map maintenance, shared by K27
// (kf_insert.cu), K28 (fuse_obs.cu) and K29 (map_cull.cu): block scans
// and reductions, the two keyframe x keypoint passes of
// slam/map_state.py (point_obs_count: each point's observations by valid
// keyframes; covisibility_counts: each keyframe's observations of the
// points one keyframe observes) and the retirement of a keyframe slot
// (slam/mapping.py::retire_keyframe: its parent, the ledger entry).
//
// Counts are integer shared-memory atomics: the results do not depend on
// the order of the adds.  Ties follow jnp.argmin / argmax: the lower index.
#pragma once

#include "common.cuh"
#include "lie_rn.cuh"

namespace {

// MapState's fields in its order (slam/map_state.py): the wrappers pass
// the map in and out as arrays of these pointers (null: not written)
enum MapField {
    KF_POSE, KF_VALID, KF_TIMESTAMP, KF_UV, KF_DEPTH, KF_LEVEL, KF_ANGLE,
    KF_DESC, KF_KP_VALID, KF_OBS_PT, KF_SEQ, PT_POS, PT_VALID, PT_DESC,
    PT_FIRST_KF, PT_FIRST_SEQ, PT_FREED_SEQ, PT_VISIBLE, PT_FOUND, LED_SEQ,
    LED_PARENT_SEQ, LED_T_CP, LED_N, N_KF, N_PT, N_MAP_FIELDS
};

struct MapPtrs {
    void* f[N_MAP_FIELDS];
    template <typename T>
    __device__ __forceinline__ T* at(int i) const {
        return static_cast<T*>(f[i]);
    }
};

__host__ inline MapPtrs mm_map(void* const* p) {
    MapPtrs m;
    for (int i = 0; i < N_MAP_FIELDS; ++i) m.f[i] = p[i];
    return m;
}

// Exclusive prefix sum of one int a thread over the block (blockDim a
// multiple of 32, at most 1024), in thread order; `total` gets the block's
// sum.  `ws`: 32 ints of shared scratch.  Two barriers.
__device__ int mm_block_scan(int x, int* ws, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) ws[warp] = incl;
    __syncthreads();
    const int w = lane < n_warps ? ws[lane] : 0;
    int wincl = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wincl, off);
        if (lane >= off) wincl += y;
    }
    const int base = __shfl_sync(0xffffffffu, wincl - w, warp);
    total = __shfl_sync(0xffffffffu, wincl, 31);
    __syncthreads();
    return base + incl - x;
}

// The block's maximum of one int a thread (every thread gets it).  `ws`:
// 32 ints of shared scratch.  Two barriers.
__device__ int mm_block_max(int x, int* ws) {
    for (int off = 16; off > 0; off >>= 1) {
        x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) ws[warp] = x;
    __syncthreads();
    int m = ws[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = max(m, ws[w]);
    __syncthreads();
    return m;
}

__device__ __forceinline__ bool mm_bit(const uint32_t* bits, int id) {
    return (bits[id >> 5] >> (id & 31)) & 1u;
}

// bits |= the points keyframe row `row` (F entries) observes: kp_valid and
// an id in [0, n) (the bitmap zeroed by the caller; the twin's
// _member_of drops nothing else: kf_obs_pt holds -1 or an id below n)
__device__ void mm_mark_row(const int* __restrict__ obs_row,
                            const uint8_t* __restrict__ kp_row, int F, int n,
                            uint32_t* bits) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        const int id = obs_row[f];
        if (kp_row[f] && id >= 0 && id < n) {
            atomicOr(bits + (id >> 5), 1u << (id & 31));
        }
    }
}

// covisibility_counts' sums over rows [r0, r1): cnt[r - r0] += the
// row's kp_valid entries whose point is set in `member` (the observing
// row's points, already ANDed with pt_valid); cnt zeroed by the caller
__device__ void mm_covis_rows(const int* __restrict__ obs,
                              const uint8_t* __restrict__ kp_valid, int F,
                              int n, int r0, int r1,
                              const uint32_t* member, int* cnt) {
    const long long first = (long long)r0 * F, total = (long long)r1 * F;
    for (long long e = first + threadIdx.x; e < total; e += blockDim.x) {
        const int id = obs[e];
        if (kp_valid[e] && id >= 0 && id < n && mm_bit(member, id)) {
            atomicAdd(cnt + (int)(e / F) - r0, 1);
        }
    }
}

// point_obs_count's adds over rows [r0, r1): cnt[min(id, n - 1)] += 1 for
// every kp_valid entry id >= 0 of a valid keyframe (the twin clamps the
// ids into [-1, n - 1]); cnt zeroed by the caller
__device__ void mm_obs_count_rows(const int* __restrict__ obs,
                                  const uint8_t* __restrict__ kp_valid,
                                  const uint8_t* __restrict__ kf_valid,
                                  int F, int n, int r0, int r1, int* cnt) {
    for (int r = r0; r < r1; ++r) {
        if (!kf_valid[r]) continue;
        const long long base = (long long)r * F;
        for (int f = threadIdx.x; f < F; f += blockDim.x) {
            const int id = obs[base + f];
            if (kp_valid[base + f] && id >= 0) {
                atomicAdd(cnt + min(id, n - 1), 1);
            }
        }
    }
}

// A keyframe slot's retirement (slam/mapping.py::retire_keyframe), masked
// by `act`: its parent is the first valid other slot of least |seq -
// seq_s| (2^30 for the rest), and a ledger entry is written at min(led_n,
// E - 1) when a parent exists and led_n < E.
struct Retire {
    int slot, act, any_cand, parent, seq_s, write, e;
};

// Warp 0 fills `r` (kf_valid, kf_seq: (K,)); the caller's barrier
// publishes it.
__device__ void mm_plan_retire(const uint8_t* __restrict__ kf_valid,
                               const int* __restrict__ kf_seq, int K,
                               int slot, bool act, const int* led_n, int E,
                               Retire* r) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int seq_s = kf_seq[slot];
    int best = 0x7fffffff, arg = 0;
    bool any = false;
    for (int j = lane; j < K; j += 32) {
        const bool cand = kf_valid[j] && j != slot;
        any |= cand;
        const int d = cand ? abs(kf_seq[j] - seq_s) : (1 << 30);
        if (d < best) {
            best = d;
            arg = j;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ob < best || (ob == best && oa < arg)) {
            best = ob;
            arg = oa;
        }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
        const int n = *led_n;
        r->slot = slot;
        r->act = act;
        r->any_cand = any;
        r->parent = arg;
        r->seq_s = seq_s;
        r->write = act && any && n < E;
        r->e = min(n, E - 1);
    }
}

// pt_first_kf after the retirement: its points move to the parent
__device__ __forceinline__ int mm_retire_first_kf(const Retire& r, int v) {
    return (r.act && r.any_cand && v == r.slot) ? r.parent : v;
}

// The ledger after the retirement, written out of place by the n_parts
// CTAs of a cluster (this one part `part`): entry e = (seq_s,
// kf_seq[parent], normalize(T_slot T_parent^-1)) when written, every
// other entry copied; part 0 writes led_n.
__device__ void mm_write_ledger(const Retire& r, const int* __restrict__ kf_seq,
                                const float* __restrict__ kf_pose,
                                const int* __restrict__ led_seq,
                                const int* __restrict__ led_parent,
                                const float* __restrict__ led_T,
                                const int* __restrict__ led_n, int E,
                                int* o_seq, int* o_parent, float* o_T,
                                int* o_n, int part, int n_parts) {
    for (int i = part * blockDim.x + threadIdx.x; i < E;
         i += n_parts * blockDim.x) {
        const bool at = r.write && i == r.e;
        o_seq[i] = at ? r.seq_s : led_seq[i];
        o_parent[i] = at ? kf_seq[r.parent] : led_parent[i];
        if (at) {
            float T[7];
            mul_inv_normalize(kf_pose + 7 * r.slot, kf_pose + 7 * r.parent, T);
            for (int k = 0; k < 7; ++k) o_T[7 * i + k] = T[k];
        } else {
            for (int k = 0; k < 7; ++k) o_T[7 * i + k] = led_T[7 * i + k];
        }
    }
    if (part == 0 && threadIdx.x == 0) {
        *o_n = min(*led_n + (r.write ? 1 : 0), E);
    }
}

__device__ __forceinline__ void mm_cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mm_cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void mm_cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

}  // namespace
