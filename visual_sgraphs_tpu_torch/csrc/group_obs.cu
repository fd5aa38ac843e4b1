// K9: observation grouping, group_observations(obs_kf, obs_pt, uvr, valid,
// n_pt, max_obs).
//
// Replaces visual_sgraphs_tpu/parallel/dist_ba.py:60 group_observations:
// flat observation lists -> per-landmark (N, O) tables, each observation in
// its landmark's next free slot.  An entry's bucket is its landmark id if
// it is valid, else n_pt; its slot is its stable rank, the number of
// earlier list entries in its bucket.  Valid entries ranked >= max_obs are
// dropped and counted; only valid entries with an id in [0, n_pt) are
// kept.  The reference (and the plain twin) sorts stably, searches the run
// starts and scatters three tables.
//
// What bounds it here: latency and memory bytes.  The local BA groups
// 11 x 1000 observations into (8192, 12) tables, the global BA 128 x 1000
// into (32768, 8); the outputs (~4.5 MB at the global BA) dominate the
// bytes.  The function needs no global table, no host-side fill and no
// second pass over the outputs.
//
// Design: one launch of S clusters of C CTAs (512 threads each, two an
// SM).  Cluster s owns the bucket slice [s W, (s + 1) W) of the buckets
// [0, n_pt]; the list is cut into C x 16 contiguous warp segments, the
// same cut in every cluster, and CTA c of each cluster walks segments
// 16 c .. 16 c + 15, so every entry is seen once by the cluster owning
// its bucket.  A warp walks its segment 32 entries at a time, eight
// steps' entries loaded at once: __match_any_sync finds the lanes that
// share a bucket (for the eight steps before any counter is read), and an
// entry's rank in the segment is the count of lower lanes among them plus
// the warp's counter for the bucket, a byte in the CTA's shared memory (16
// rows of W bytes), which the lowest of them advances.  Each entry's
// bucket code and rank stay in shared memory for the second walk.  Ranks
// only matter below max_obs, so counters saturate at max_obs (an entry at
// or past it is dropped whatever its exact rank).  Each CTA then scans its
// 16 rows into per-warp offsets and its own totals (four buckets a word;
// byte-wise adds, saturating only when max_obs > 15 could overflow a
// byte), one cluster barrier publishes the totals, and each CTA adds up
// the totals of the CTAs before it through distributed shared memory.
// Stability, lower list position first, holds by construction.  The
// second walk writes each kept entry at (landmark, rank), the kept rows'
// loads issued together; each CTA writes the fill values (-1, 0, false)
// of the empty slots of its 1/C share of the slice's landmarks from the
// cluster's totals.  Every output element is written once.
//
// Valid entries whose id lies outside [0, n_pt] rank among the entries of
// the same id.  Cluster 0 appends them to a per-CTA region of a scratch
// list as it walks, and after the cluster barrier its CTAs rank them by
// counting the earlier entries of the same id in the regions of the CTAs
// up to theirs (quadratic in their number: no caller passes them, and the
// count stays exact for any number).
//
// n_dropped: each cluster sums its CTAs' drops in CTA 0's shared memory
// (integer atomics); CTA 0 writes the cluster's sum to a scratch slot and
// takes a ticket from a device counter; the last cluster sums the slots in
// order, writes n_dropped and resets the counter to 0 for the next launch.
// The counter is shared by every launch on the device, so launches of this
// kernel must not overlap (the port issues them on one stream).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int HEADER = 16;  // bytes: [0] side entries, [1] cluster drops
constexpr int UNROLL = 8;  // warp steps whose entries are loaded at once
constexpr int MAX_CLUSTER = 8;

__device__ unsigned int g_group_ticket = 0;

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// a + b byte by byte; saturating at 255 (then capped at the O in orep)
// unless every byte sum is known to stay below 256 (kSmall: O <= 15, at
// most 16 rows or 8 CTAs of counts <= O)
template <bool kSmall>
__device__ __forceinline__ uint32_t add4(uint32_t a, uint32_t b,
                                         uint32_t orep) {
    return kSmall ? a + b : __vminu4(__vaddus4(a, b), orep);
}

// the bucket in [0, n_pt] of an entry with validity v and id p, or -1 for
// a valid id outside it
__device__ __forceinline__ int bucket_of(uint8_t v, int p, int n_pt) {
    const int b = v ? p : n_pt;
    return (unsigned)b <= (unsigned)n_pt ? b : -1;
}

// two CTAs an SM (<= 64 registers a thread), so a cluster of every slice
// is resident at once
template <bool kSmall>
__global__ void __launch_bounds__(THREADS, 2)
group_obs_kernel(const int* __restrict__ obs_kf, const int* __restrict__ obs_pt,
                 const float* __restrict__ uvr,
                 const uint8_t* __restrict__ valid, int m, int n_pt, int O,
                 int width, int seg, int* side, int* part,
                 int* __restrict__ out_kf, float* __restrict__ out_uvr,
                 uint8_t* __restrict__ out_valid, int* n_dropped) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* hdr = reinterpret_cast<int*>(smem);
    uint8_t* rows = smem + HEADER;           // WARPS x width
    uint8_t* tot = rows + WARPS * width;     // this CTA's totals
    uint8_t* base = tot + width;             // totals of the CTAs before
    uint8_t* full = base + width;            // the cluster's totals
    // each entry of the CTA's segment: its code (0xffff: not this slice's;
    // else the bucket's offset in the slice, bit 14 set when valid) and
    // its rank in its warp's segment
    uint16_t* code = reinterpret_cast<uint16_t*>(full + width);
    uint8_t* lrank = reinterpret_cast<uint8_t*>(code + WARPS * seg);
    uint32_t* rows32 = reinterpret_cast<uint32_t*>(rows);
    uint32_t* tot32 = reinterpret_cast<uint32_t*>(tot);
    uint32_t* base32 = reinterpret_cast<uint32_t*>(base);
    uint32_t* full32 = reinterpret_cast<uint32_t*>(full);

    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks();
    const int c = (int)cl.block_rank();
    const int s = blockIdx.x / C;
    const int S = gridDim.x / C;
    const int lo = s * width;
    const int words = width >> 2;
    const uint32_t orep = 0x01010101u * (uint32_t)O;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int i = tid; i < WARPS * words; i += THREADS) rows32[i] = 0;
    if (tid < 2) hdr[tid] = 0;
    __syncthreads();

    // 1. ranks within the warp's segment, saturating counters
    const int e0 = min(m, (c * WARPS + warp) * seg);
    const int e1 = min(m, e0 + seg);
    const int cta0 = c * WARPS * seg;  // the CTA's first entry
    uint8_t* row = rows + warp * width;
    int* region = side + c * WARPS * seg;
    const unsigned lower = (1u << lane) - 1u;
    for (int b0 = e0; b0 < e1; b0 += 32 * UNROLL) {
        int bk[UNROLL];
        uint8_t vk[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int e = b0 + 32 * u + lane;
            vk[u] = e < e1 ? valid[e] : 0;
            bk[u] = e < e1 ? bucket_of(vk[u], obs_pt[e], n_pt) : n_pt + 1;
        }
        // the buckets' peer masks first (independent of the counters),
        // then the counter chain: every lane of a bucket reads its count,
        // the lowest writes it back
        int key[UNROLL];
        unsigned peers[UNROLL];
        bool side_any = false;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int b = bk[u];
            key[u] = b >= lo && b < lo + width && b <= n_pt ? b - lo : -1;
            peers[u] = __match_any_sync(0xffffffffu, key[u]);
            side_any |= b < 0;
        }
        if (s == 0 && __any_sync(0xffffffffu, side_any)) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (bk[u] < 0) region[atomicAdd(&hdr[0], 1)] = b0 + 32 * u + lane;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int e = b0 + 32 * u + lane;
            if (key[u] >= 0) {
                const int cnt = row[key[u]];
                lrank[e - cta0] =
                    (uint8_t)min(O, cnt + __popc(peers[u] & lower));
                if ((peers[u] & lower) == 0) {
                    row[key[u]] = (uint8_t)min(O, cnt + __popc(peers[u]));
                }
            }
            if (e < e1) {
                code[e - cta0] = key[u] < 0 ? 0xffff
                                 : (uint16_t)(key[u] | (vk[u] ? 0x4000 : 0));
            }
            __syncwarp();
        }
    }
    __syncthreads();

    // 2. per-warp exclusive offsets and this CTA's totals, four buckets a
    // word
    for (int q = tid; q < words; q += THREADS) {
        uint32_t x[WARPS];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) x[w] = rows32[w * words + q];
        uint32_t run = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            rows32[w * words + q] = run;
            run = add4<kSmall>(run, x[w], orep);
        }
        tot32[q] = __vminu4(run, orep);
    }
    cluster_arrive();
    cluster_wait();

    // 3. the totals of the CTAs before this one; the cluster's totals of
    // this CTA's share of the slice (for the fills)
    // (every CTA's word is loaded before the first add)
    for (int q = tid; q < words; q += THREADS) {
        uint32_t t[MAX_CLUSTER];
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k) {
            t[k] = cl.map_shared_rank(tot32, k < C ? k : 0)[q];
        }
        uint32_t acc = 0;
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k) {
            acc = add4<kSmall>(acc, k < c ? t[k] : 0u, orep);
        }
        base32[q] = acc;
    }
    const int share = (words + C - 1) / C;
    const int q0 = min(words, c * share), q1 = min(words, q0 + share);
    for (int q = q0 + tid; q < q1; q += THREADS) {
        uint32_t t[MAX_CLUSTER];
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k) {
            t[k] = cl.map_shared_rank(tot32, k < C ? k : 0)[q];
        }
        uint32_t acc = 0;
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k) {
            acc = add4<kSmall>(acc, k < C ? t[k] : 0u, orep);
        }
        full32[q] = acc;
    }

    // 4. valid ids outside [0, n_pt]: rank among the same id (cluster 0)
    int drops = 0;
    if (s == 0) {
        const int n_side = hdr[0];
        for (int i = tid; i < n_side; i += THREADS) {
            const int e = region[i];
            const int id = obs_pt[e];
            int cnt = 0;
            for (int k = 0; k <= c && cnt < O; ++k) {
                const int n_k = *cl.map_shared_rank(&hdr[0], k);
                const int* reg = side + k * WARPS * seg;
                for (int j = 0; j < n_k && cnt < O; ++j) {
                    const int f = reg[j];
                    cnt += f < e && obs_pt[f] == id;
                }
            }
            drops += cnt >= O;
        }
    }
    __syncthreads();

    // 5. kept entries at (landmark, rank), from the codes and ranks of
    // step 1; drops counted.  The kept entries' rows are loaded together,
    // then written.
    for (int b0 = e0; b0 < e1; b0 += 32 * UNROLL) {
        int slot[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int e = b0 + 32 * u + lane;
            slot[u] = -1;
            if (e >= e1) continue;
            const int cd = code[e - cta0];
            if (cd == 0xffff) continue;
            const int k = cd & 0x3fff;
            const int r = base[k] + row[k] + lrank[e - cta0];
            if (r >= O) {
                drops += (cd >> 14) & 1;
            } else if (lo + k < n_pt) {
                slot[u] = (lo + k) * O + r;
            }
        }
        int kf[UNROLL];
        float p0[UNROLL], p1[UNROLL], p2[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const size_t e = (size_t)(b0 + 32 * u + lane);
            const bool keep = slot[u] >= 0;
            kf[u] = keep ? obs_kf[e] : 0;
            p0[u] = keep ? uvr[3 * e + 0] : 0.0f;
            p1[u] = keep ? uvr[3 * e + 1] : 0.0f;
            p2[u] = keep ? uvr[3 * e + 2] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (slot[u] < 0) continue;
            const size_t t = slot[u];
            out_kf[t] = kf[u];
            out_uvr[3 * t + 0] = p0[u];
            out_uvr[3 * t + 1] = p1[u];
            out_uvr[3 * t + 2] = p2[u];
            out_valid[t] = 1;
        }
    }

    // 6. fill values in the empty slots of this CTA's share
    const int k0 = 4 * q0;
    const int k1 = min(4 * q1, n_pt - lo);
    for (int i = tid; i < (k1 - k0) * O; i += THREADS) {
        const int k = k0 + i / O, r = i % O;
        if (r < full[k]) continue;  // full[k] >= O counts as O
        const size_t slot = (size_t)(lo + k) * O + r;
        out_kf[slot] = -1;
        out_uvr[3 * slot + 0] = 0.0f;
        out_uvr[3 * slot + 1] = 0.0f;
        out_uvr[3 * slot + 2] = 0.0f;
        out_valid[slot] = 0;
    }

    // 7. n_dropped: the cluster's sum, then the last cluster's total
    for (int off = 16; off > 0; off >>= 1) {
        drops += __shfl_xor_sync(0xffffffffu, drops, off);
    }
    if (lane == 0 && drops) atomicAdd(cl.map_shared_rank(&hdr[1], 0), drops);
    cluster_arrive();
    cluster_wait();
    if (c == 0 && tid == 0) {
        part[s] = hdr[1];
        __threadfence();
        if (atomicAdd(&g_group_ticket, 1u) == (unsigned)(S - 1)) {
            __threadfence();
            int sum = 0;
            for (int i = 0; i < S; ++i) sum += ((volatile int*)part)[i];
            *n_dropped = sum;
            atomicExch(&g_group_ticket, 0u);
        }
    }
}

}  // namespace

// obs_kf, obs_pt: (m,) i32; uvr: (m, 3) f32; valid: (m,) bool.  The plan
// (dist_ba.py::group_plan): S slices of width buckets (a multiple of 4,
// S x width > n_pt), clusters of C CTAs, warp segments of seg entries
// (C x 16 x seg >= m), smem bytes of shared memory a CTA.  Scratch, none
// of it initialised: side (C x 16 x seg,) i32, part (S,) i32.  Writes
// every element of out_kf (n_pt, max_obs) i32, out_uvr (n_pt, max_obs, 3)
// f32, out_valid (n_pt, max_obs) bool and n_dropped () i32.
VSG_API int vsg_group_obs(const int* obs_kf, const int* obs_pt,
                          const float* uvr, const uint8_t* valid, int m,
                          int n_pt, int max_obs, int S, int width, int C,
                          int seg, int smem, int* side, int* part,
                          int* out_kf, float* out_uvr,
                          uint8_t* out_valid, int* n_dropped,
                          cudaStream_t stream) {
    if (max_obs < 1 || max_obs > 255 || width % 4 != 0 || C < 1
        || C > MAX_CLUSTER
        || (long long)S * width <= n_pt || (long long)C * WARPS * seg < m
        || (long long)n_pt * max_obs > 0x7fffffff) {
        return (int)cudaErrorInvalidValue;
    }
    const bool small = max_obs <= 15;
    static int smem_set = 0;
    cudaError_t err;
    if (smem > smem_set) {
        err = cudaFuncSetAttribute(group_obs_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                group_obs_kernel<false>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        }
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S * C, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg,
                             small ? group_obs_kernel<true>
                                   : group_obs_kernel<false>,
                             obs_kf, obs_pt, uvr,
                             valid, m, n_pt, max_obs, width, seg, side, part,
                             out_kf, out_uvr, out_valid, n_dropped);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
