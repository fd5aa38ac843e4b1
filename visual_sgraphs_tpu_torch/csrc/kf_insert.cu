// K27: the keyframe program's found statistics and keyframe insertion.
//
// Replaces visual_sgraphs_tpu/slam/mapping.py:194 apply_found_stats (and
// slam/tracking.py:517 update_point_stats, the serial frame's form of it)
// and :93 insert_keyframe with :45 retire_keyframe, which the port ran as
// ~10 and ~250 eager torch operations (slam/mapping.py).  Two entries:
// - vsg_found_stats: pt_found += the (B, F) found ids, pt_visible += the
//   (B, V) visible ids (-1 and ids past N dropped, as the reference's
//   mode="drop"), the rows of frames whose packed inlier count is below
//   min_inliers skipped (the cycle's acceptance mask), written out of
//   place.  Integer adds: exact, independent of their order.
// - vsg_kf_insert: one keyframe, in the reference's order: the program's
//   stats fold (it comes first: the insertion resets its new points'
//   counters to 1); the retirement of a still-valid occupant of slot k
//   (its parent, the ledger entry, pt_first_kf moved to the parent); the
//   free ids (~pt_valid & n_kf - pt_freed_seq >= quarantine, the first F
//   ascending); the cumsum allocation to the keypoints with depth that
//   matched no point; their back-projection; the new point rows, row k of
//   every keyframe table, kf_seq, n_kf, n_pt.  Every changed field is
//   written out of place (the map is never modified), so the clones of
//   the plain chain are part of the launch.
//
// Duplicate scatters: the reference writes point rows through
// .at[safe].set with safe = max(new_id, 0), so every keypoint that
// allocates nothing writes point 0's old row, in keypoint order, and the
// last writer wins.  Point 0 therefore takes its new row only when its
// allocating keypoint is the last with safe == 0 (an empty map's first
// keyframe allocates point 0 to its first new keypoint and a later
// keypoint without depth writes the old row back).  The kernel gives the
// same fields (ROADMAP.md, queue 3).
//
// What bounds it here: bytes.  Out of place at the cells' capacities (K =
// 128, F = 1000, N = 32768) the keyframe tables are ~7.3 MB (kf_desc 4.1
// MB, kf_uv 1.0 MB) and the point tables ~2.0 MB, each read and written
// once: ~19 MB, ~0.006 ms at 3.35 TB/s.  The serial keyframe's fold adds
// its 32 x (1000 + 4096) ids.
//
// Design: one launch of clusters of 8 CTAs of 1024 threads.
// - Cluster 0 owns the points: CTA r a slice of N / 8 points, its found
//   and visible counters in shared memory (the fold adds the ids in its
//   slice, read by every CTA of the cluster).  Each CTA counts its
//   slice's free points and scans them (a block scan), the 8 slice totals
//   meet through distributed shared memory (one cluster barrier) and give
//   each free point its rank; every CTA computes the keypoints'
//   allocation order (a block scan over F) and back-projection (F x 3
//   floats in shared memory), so a free point of rank r < min(new, free)
//   belongs to the r-th new keypoint: the CTA writes its point rows and
//   that keypoint's entry of kf_obs_pt's row k; CTA 0 finds point 0's
//   last writer, writes the row's other entries (slot_pt) and the small
//   fields (kf_pose, kf_valid, kf_timestamp, kf_seq, n_kf, n_pt; the
//   ledger, 4096 entries at the default capacity, by all eight).  The
//   allocation table is the grid-wide dependency: it needs one cluster,
//   not a second launch.
// - Clusters 1-15 copy the keyframe tables (kf_uv, kf_depth, kf_level,
//   kf_angle, kf_desc, kf_kp_valid and kf_obs_pt but its row k) in
//   16-byte chunks, row k from the frame.
// The pose algebra rounds op for op as the torch chain on the card
// (lie_rn.cuh); every integer and decision is exact.
//
// vsg_found_stats: one CTA a slice of 2048 points (16 CTAs at N =
// 32768), its counters in shared memory, every CTA reading all the ids.
#include <cooperative_groups.h>

#include "common.cuh"
#include "lie_rn.cuh"
#include "map_maint.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 8;
constexpr int BULK_CLUSTERS = 15;
constexpr int STATS_SLICE = 2048;
constexpr int N_BULK = 7;

// (rows, len) ids, row-major, -1 padded
struct Ids {
    const int* ids;
    int rows, len;
};

// cnt[id - lo] += 1 for every id in [lo, hi) of `s`, skipping the rows
// whose packed inlier count (packeds[4 row + 1]) is below min_inl when
// packeds is given
__device__ void fold_ids(Ids s, const float* __restrict__ packeds,
                         float min_inl, int lo, int hi, int* cnt) {
    if (s.ids == nullptr || s.rows == 0) return;
    const long long total = (long long)s.rows * s.len;
    if ((s.len & 3) == 0 && ((uintptr_t)s.ids & 15) == 0) {
        const int4* q = reinterpret_cast<const int4*>(s.ids);
        const long long n4 = total >> 2;
        for (long long c = threadIdx.x; c < n4; c += blockDim.x) {
            if (packeds != nullptr &&
                !(packeds[4 * (int)((c << 2) / s.len) + 1] >= min_inl)) {
                continue;
            }
            const int4 v = __ldg(q + c);
            const int id4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (id4[j] >= lo && id4[j] < hi) {
                    atomicAdd(cnt + id4[j] - lo, 1);
                }
            }
        }
        return;
    }
    for (long long e = threadIdx.x; e < total; e += blockDim.x) {
        if (packeds != nullptr &&
            !(packeds[4 * (int)(e / s.len) + 1] >= min_inl)) {
            continue;
        }
        const int id = __ldg(s.ids + e);
        if (id >= lo && id < hi) atomicAdd(cnt + id - lo, 1);
    }
}

__global__ void __launch_bounds__(THREADS)
found_stats_kernel(const int* __restrict__ found,
                   const int* __restrict__ visible, int N, Ids fnd, Ids vis,
                   const float* __restrict__ packeds, float min_inl,
                   int* __restrict__ out_found, int* __restrict__ out_visible) {
    __shared__ int sf[STATS_SLICE], sv[STATS_SLICE];
    const int lo = blockIdx.x * STATS_SLICE;
    const int hi = min(N, lo + STATS_SLICE);
    for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
        sf[p - lo] = found[p];
        sv[p - lo] = visible[p];
    }
    __syncthreads();
    fold_ids(fnd, packeds, min_inl, lo, hi, sf);
    fold_ids(vis, packeds, min_inl, lo, hi, sv);
    __syncthreads();
    for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
        out_found[p] = sf[p - lo];
        out_visible[p] = sv[p - lo];
    }
}

// The inserted frame (its keypoint tables are rows of the keyframe
// tables' layout) and its keyframe operands
struct Frame {
    const float* uv;        // (F, 2)
    const float* depth;     // (F,)
    const int* level;       // (F,)
    const float* angle;     // (F,)
    const uint8_t* desc;    // (F, 32), 16-byte aligned
    const uint8_t* valid;   // (F,)
    const float* ts;        // ()
    const float* pose;      // (7,) T_cw
    const int* slot_pt;     // (F,) matched point ids or -1
    const float* cam;       // (4,) fx, fy, cx, cy
};

// The copied keyframe tables: field t is K rows of row_bytes, row k taken
// from row[t] (skipped when null: written by cluster 0)
struct Bulk {
    const char* src[N_BULK];
    char* dst[N_BULK];
    const char* row[N_BULK];
    long long row_bytes[N_BULK];
    long long first[N_BULK + 1];  // 16-byte chunks before field t
};

// chunk c of the bulk tables: a 16-byte copy where it misses row k (or
// lies inside it with an aligned frame row), else byte by byte
__device__ __forceinline__ bool bulk_fast(const Bulk& b, long long c, int k,
                                          int K, const int4** from,
                                          int4** to) {
    int t = 0;
    while (c >= b.first[t + 1]) ++t;
    const long long o = (c - b.first[t]) << 4;
    const long long rb = b.row_bytes[t], bytes = rb * K;
    const long long lo = rb * k, hi = lo + rb;
    if (o + 16 > bytes) return false;
    *to = reinterpret_cast<int4*>(b.dst[t] + o);
    if (o + 16 <= lo || o >= hi) {
        *from = reinterpret_cast<const int4*>(b.src[t] + o);
        return true;
    }
    const char* r = b.row[t];
    if (r != nullptr && o >= lo && o + 16 <= hi &&
        ((uintptr_t)(r + (o - lo)) & 15) == 0) {
        *from = reinterpret_cast<const int4*>(r + (o - lo));
        return true;
    }
    return false;
}

__device__ void bulk_slow(const Bulk& b, long long c, int k, int K) {
    int t = 0;
    while (c >= b.first[t + 1]) ++t;
    const long long o = (c - b.first[t]) << 4;
    const long long rb = b.row_bytes[t], bytes = rb * K;
    const long long lo = rb * k, hi = lo + rb;
    for (long long x = o; x < min(o + 16, bytes); ++x) {
        if (x < lo || x >= hi) {
            b.dst[t][x] = b.src[t][x];
        } else if (b.row[t] != nullptr) {
            b.dst[t][x] = b.row[t][x - lo];
        }
    }
}

// The bulk clusters: every chunk once, four in flight a thread
__device__ void bulk_copy(const Bulk& b, int k, int K, int cta, int n_ctas) {
    const long long total = b.first[N_BULK];
    const long long stride = (long long)n_ctas * THREADS;
    for (long long base = (long long)cta * THREADS + threadIdx.x;
         base < total; base += 4 * stride) {
        int4 v[4];
        int4* to[4];
        bool fast[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const long long c = base + u * stride;
            const int4* from = nullptr;
            fast[u] = c < total && bulk_fast(b, c, k, K, &from, &to[u]);
            if (fast[u]) v[u] = __ldg(from);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const long long c = base + u * stride;
            if (fast[u]) {
                *to[u] = v[u];
            } else if (c < total) {
                bulk_slow(b, c, k, K);
            }
        }
    }
}

struct Dims {
    int K, F, N, E, k, quarantine;
};

__device__ __forceinline__ bool allocatable(const uint8_t* valid,
                                            const int* freed, int n_kf,
                                            int quarantine, int p) {
    return !valid[p] && n_kf - freed[p] >= quarantine;
}

__device__ __forceinline__ bool new_kp(const Frame& fr, int i) {
    return fr.valid[i] && fr.depth[i] > 0.0f && fr.slot_pt[i] < 0;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
kf_insert_kernel(MapPtrs in, MapPtrs out, Frame fr, Dims d, Ids fnd,
                 Ids vis, Bulk bulk) {
    if (blockIdx.x >= CLUSTER) {
        bulk_copy(bulk, d.k, d.K, blockIdx.x - CLUSTER,
                  gridDim.x - CLUSTER);
        return;
    }
    const int K = d.K, F = d.F, N = d.N, k = d.k;
    const int S = (N + CLUSTER - 1) / CLUSTER;
    extern __shared__ int sh[];
    int* fnd_s = sh;                 // (S) found, folded
    int* vis_s = fnd_s + S;          // (S) visible, folded
    int* owner = vis_s + S;          // (S) the keypoint a point takes, or -1
    int* kp_of_rank = owner + S;     // (F) the r-th new keypoint
    float* pw = reinterpret_cast<float*>(kp_of_rank + F);  // (F, 3)
    __shared__ int ws[32];
    __shared__ int tot_sh;
    __shared__ Retire ret;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x;
    const int lo = min(N, rank * S), hi = min(N, lo + S);

    const uint8_t* kf_valid = in.at<uint8_t>(KF_VALID);
    const int* kf_seq = in.at<int>(KF_SEQ);
    const int n_kf = *in.at<int>(N_KF);
    mm_plan_retire(kf_valid, kf_seq, K, k, kf_valid[k] != 0,
                   in.at<int>(LED_N), d.E, &ret);

    // the stats fold into the slice's counters
    const int* found = in.at<int>(PT_FOUND);
    const int* visible = in.at<int>(PT_VISIBLE);
    for (int p = lo + tid; p < hi; p += THREADS) {
        fnd_s[p - lo] = found[p];
        vis_s[p - lo] = visible[p];
    }
    __syncthreads();
    fold_ids(fnd, nullptr, 0.0f, lo, hi, fnd_s);
    fold_ids(vis, nullptr, 0.0f, lo, hi, vis_s);

    // the slice's free points: thread t owns ppt consecutive ones
    const uint8_t* pt_valid = in.at<uint8_t>(PT_VALID);
    const int* freed = in.at<int>(PT_FREED_SEQ);
    const int ppt = (S + THREADS - 1) / THREADS;
    const int p0 = lo + tid * ppt;
    int n_mine = 0;
    for (int j = 0; j < ppt; ++j) {
        const int p = p0 + j;
        if (p < hi && allocatable(pt_valid, freed, n_kf, d.quarantine, p)) {
            ++n_mine;
        }
    }
    int slice_total;
    const int excl = mm_block_scan(n_mine, ws, slice_total);
    if (tid == 0) tot_sh = slice_total;

    // the keypoints' allocation order: thread t owns kpt consecutive ones
    const int kpt = (F + THREADS - 1) / THREADS;
    const int i0 = tid * kpt;
    int k_mine = 0;
    for (int j = 0; j < kpt; ++j) {
        if (i0 + j < F && new_kp(fr, i0 + j)) ++k_mine;
    }
    int n_new;
    const int kexcl = mm_block_scan(k_mine, ws, n_new);
    {
        int o = kexcl;
        for (int j = 0; j < kpt; ++j) {
            if (i0 + j < F && new_kp(fr, i0 + j)) kp_of_rank[o++] = i0 + j;
        }
    }
    float T_wc[7];
    se3_inv_rn(fr.pose, T_wc);
    for (int i = tid; i < F; i += THREADS) {
        backproject_rn(fr.cam, fr.uv[2 * i], fr.uv[2 * i + 1], fr.depth[i],
                       T_wc, pw + 3 * i);
    }

    // the slices' free counts through distributed shared memory
    mm_cluster_sync();
    int offset = 0, n_free = 0;
    for (int r = 0; r < CLUSTER; ++r) {
        const int v = *cluster.map_shared_rank(&tot_sh, r);
        if (r < rank) offset += v;
        n_free += v;
    }
    mm_cluster_arrive();
    const int n_alloc = min(n_new, n_free);
    int* obs_row = out.at<int>(KF_OBS_PT) + (long long)k * F;

    // point 0 takes its new row only from the last keypoint whose safe id
    // is 0: the last that allocates nothing, or point 0's own
    bool win0 = false;
    if (rank == 0) {
        const bool free0 = hi > 0 &&
                           allocatable(pt_valid, freed, n_kf, d.quarantine, 0);
        int last = -1, o = kexcl;
        for (int j = 0; j < kpt; ++j) {
            const int i = i0 + j;
            if (i >= F) break;
            const bool nk = new_kp(fr, i);
            const bool alloc = nk && o < n_free;
            if (!alloc) obs_row[i] = fr.slot_pt[i];
            if (!alloc || (free0 && o == 0)) last = i;
            if (nk) ++o;
        }
        const int last0 = mm_block_max(last, ws);
        win0 = free0 && n_alloc > 0 && kp_of_rank[0] == last0;
    }

    // each free point of rank < n_alloc takes its keypoint
    {
        int r = offset + excl;
        for (int j = 0; j < ppt; ++j) {
            const int p = p0 + j;
            if (p >= hi) break;
            int own = -1;
            if (allocatable(pt_valid, freed, n_kf, d.quarantine, p)) {
                if (r < n_alloc) {
                    const int kp = kp_of_rank[r];
                    obs_row[kp] = p;
                    if (p != 0 || win0) own = kp;
                }
                ++r;
            }
            owner[p - lo] = own;
        }
    }
    __syncthreads();

    // the slice's point rows
    const int ns = hi - lo;
    {
        const float* src = in.at<float>(PT_POS) + 3LL * lo;
        float* dst = out.at<float>(PT_POS) + 3LL * lo;
        for (int j = tid; j < 3 * ns; j += THREADS) {
            const int o = owner[j / 3];
            dst[j] = o >= 0 ? pw[3 * o + j % 3] : src[j];
        }
    }
    {
        const int4* src =
            reinterpret_cast<const int4*>(in.at<uint8_t>(PT_DESC)) + 2LL * lo;
        int4* dst =
            reinterpret_cast<int4*>(out.at<uint8_t>(PT_DESC)) + 2LL * lo;
        const int4* fd = reinterpret_cast<const int4*>(fr.desc);
        for (int j = tid; j < 2 * ns; j += THREADS) {
            const int o = owner[j >> 1];
            dst[j] = o >= 0 ? fd[2 * o + (j & 1)] : src[j];
        }
    }
    {
        uint8_t* valid_o = out.at<uint8_t>(PT_VALID);
        const int* first_kf = in.at<int>(PT_FIRST_KF);
        int* first_kf_o = out.at<int>(PT_FIRST_KF);
        const int* first_seq = in.at<int>(PT_FIRST_SEQ);
        int* first_seq_o = out.at<int>(PT_FIRST_SEQ);
        int* vis_o = out.at<int>(PT_VISIBLE);
        int* fnd_o = out.at<int>(PT_FOUND);
        for (int p = lo + tid; p < hi; p += THREADS) {
            const bool own = owner[p - lo] >= 0;
            valid_o[p] = own ? 1 : pt_valid[p];
            first_kf_o[p] = own ? k : mm_retire_first_kf(ret, first_kf[p]);
            first_seq_o[p] = own ? n_kf : first_seq[p];
            vis_o[p] = own ? 1 : vis_s[p - lo];
            fnd_o[p] = own ? 1 : fnd_s[p - lo];
        }
    }

    if (rank == 0) {
        const float* pose = in.at<float>(KF_POSE);
        float* pose_o = out.at<float>(KF_POSE);
        for (int j = tid; j < 7 * K; j += THREADS) {
            pose_o[j] = j / 7 == k ? fr.pose[j % 7] : pose[j];
        }
        const float* ts = in.at<float>(KF_TIMESTAMP);
        float* ts_o = out.at<float>(KF_TIMESTAMP);
        uint8_t* valid_o = out.at<uint8_t>(KF_VALID);
        int* seq_o = out.at<int>(KF_SEQ);
        for (int r = tid; r < K; r += THREADS) {
            valid_o[r] = r == k ? 1 : kf_valid[r];
            ts_o[r] = r == k ? *fr.ts : ts[r];
            seq_o[r] = r == k ? n_kf : kf_seq[r];
        }
        if (tid == 0) {
            *out.at<int>(N_KF) = n_kf + 1;
            *out.at<int>(N_PT) = *in.at<int>(N_PT) + n_alloc;
        }
    }
    mm_write_ledger(ret, kf_seq, in.at<float>(KF_POSE), in.at<int>(LED_SEQ),
                    in.at<int>(LED_PARENT_SEQ), in.at<float>(LED_T_CP),
                    in.at<int>(LED_N), d.E, out.at<int>(LED_SEQ),
                    out.at<int>(LED_PARENT_SEQ), out.at<float>(LED_T_CP),
                    out.at<int>(LED_N), rank, CLUSTER);
    // peers read this CTA's tot_sh until they arrive
    mm_cluster_wait();
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

}  // namespace

// found, visible: (N,) i32; fids: (frows, flen) i32 found ids, vids:
// (vrows, vlen) i32 visible ids (null or 0 rows: none); packeds: (rows, 4)
// f32 or null, rows with packeds[:, 1] < min_inl skipped; out_found,
// out_visible: (N,) i32
VSG_API int vsg_found_stats(const int* found, const int* visible, int N,
                            const int* fids, int frows, int flen,
                            const int* vids, int vrows, int vlen,
                            const float* packeds, float min_inl,
                            int* out_found, int* out_visible,
                            cudaStream_t stream) {
    if (N <= 0) return 0;
    const int grid = (N + STATS_SLICE - 1) / STATS_SLICE;
    found_stats_kernel<<<grid, THREADS, 0, stream>>>(
        found, visible, N, Ids{fids, frows, flen}, Ids{vids, vrows, vlen},
        packeds, min_inl, out_found, out_visible);
    return (int)cudaGetLastError();
}

// in, out: the map's 25 field pointers in MapState's order (out: every
// field but pt_freed_seq); frame: uv, depth, level, angle, desc, valid,
// timestamp, pose, slot_pt, cam_K; (K, F, N, E) the capacities; k the
// slot; fids (frows, F) / vids (vrows, vlen): the program's stats (0 rows:
// none)
VSG_API int vsg_kf_insert(void* const* in, void* const* out,
                          void* const* frame, int K, int F, int N, int E,
                          int k, int quarantine, const int* fids, int frows,
                          const int* vids, int vrows, int vlen,
                          cudaStream_t stream) {
    if (k < 0 || k >= K || F <= 0 || N <= 0 || E <= 0 ||
        ((uintptr_t)frame[4] & 15) != 0 || ((uintptr_t)in[PT_DESC] & 15) ||
        ((uintptr_t)out[PT_DESC] & 15)) {
        return (int)cudaErrorInvalidValue;
    }
    const MapPtrs mi = mm_map(in), mo = mm_map(out);
    const Frame fr{(const float*)frame[0],   (const float*)frame[1],
                   (const int*)frame[2],     (const float*)frame[3],
                   (const uint8_t*)frame[4], (const uint8_t*)frame[5],
                   (const float*)frame[6],   (const float*)frame[7],
                   (const int*)frame[8],     (const float*)frame[9]};
    // the copied tables and their frame rows (kf_obs_pt's row k: cluster 0)
    const int fields[N_BULK] = {KF_UV,    KF_DEPTH,    KF_LEVEL, KF_ANGLE,
                                KF_DESC,  KF_KP_VALID, KF_OBS_PT};
    const int rows[N_BULK] = {0, 1, 2, 3, 4, 5, -1};
    const long long row_bytes[N_BULK] = {8LL * F, 4LL * F, 4LL * F, 4LL * F,
                                         32LL * F, 1LL * F, 4LL * F};
    Bulk b;
    b.first[0] = 0;
    for (int t = 0; t < N_BULK; ++t) {
        b.src[t] = (const char*)in[fields[t]];
        b.dst[t] = (char*)out[fields[t]];
        if ((((uintptr_t)b.src[t] | (uintptr_t)b.dst[t]) & 15) != 0) {
            return (int)cudaErrorInvalidValue;
        }
        b.row[t] = rows[t] < 0 ? nullptr : (const char*)frame[rows[t]];
        b.row_bytes[t] = row_bytes[t];
        b.first[t + 1] = b.first[t] + (row_bytes[t] * K + 15) / 16;
    }
    const int S = (N + CLUSTER - 1) / CLUSTER;
    const size_t smem = sizeof(int) * (3 * (size_t)S + F) + 12 * (size_t)F;
    static size_t set = 0;
    const cudaError_t e = smem_for(kf_insert_kernel, smem, set);
    if (e != cudaSuccess) return (int)e;
    kf_insert_kernel<<<CLUSTER * (1 + BULK_CLUSTERS), THREADS, smem,
                       stream>>>(mi, mo, fr, Dims{K, F, N, E, k, quarantine},
                                 Ids{fids, frows, F}, Ids{vids, vrows, vlen},
                                 b);
    return (int)cudaGetLastError();
}
