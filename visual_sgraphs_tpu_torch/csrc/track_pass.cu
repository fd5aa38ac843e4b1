// K5 as the tracking pass: the local map's projection and visibility, the
// binned window match with its duplicate resolution, and the pose solve's
// gathers, in one launch.
//
// Replaces, in visual_sgraphs_tpu/slam/tracking.py::_track_frame_impl,
// one pass of predict_uv (tracking.py:271-285: se3_apply, project_pinhole,
// the depth and image-bound gates), features/match.py::match_window
// (match.py:104) on its result, and the gathers frame.uv[slot] /
// frame.depth[slot] that feed pose_only_gn (tracking.py:302).  The JAX
// version masks and top-2s a dense (N, F) Hamming matrix built on the
// matrix unit, then scatters a claim table; in the port that pass was ~30
// eager operations around K5's two launches and a fill.
//
// What bounds it here: latency.  One pass reads ~200 KB (N = 4096 local
// points' positions and descriptors, F = 1000 keypoints) and does ~1e6
// integer operations once the window prunes the pairs; as separate
// launches it waited on the host.
//
// Design: one cluster of C CTAs (C <= 8, 512 threads each), queries spread
// over the cluster, one thread a query.
// - Every CTA builds a cell grid of the frame's valid keypoints in shared
//   memory (a counting sort by cell: counts with shared atomics, a block
//   scan, a scatter of each keypoint's pixel, descriptor and index).
//   Cells are at least the radius wide (track_pass_plan); a keypoint and
//   a query's window bound are clamped into the grid, which keeps every
//   in-window pair inside the bounding box (clamping is monotone), so the
//   cells scanned are a superset of the window and the window test itself
//   is unchanged: the result equals a scan over all F keypoints.
// - A query projects its point (the twin's float32 operations one by one,
//   rounding intrinsics, so uv_pred is bitwise the twin's), gates it, and
//   scans the one contiguous run of sorted keypoints each grid row of its
//   bounding box holds, keeping the best two by (distance, index): the
//   lower index wins a tie, as lax.top_k orders it, and the second-best is
//   by value, duplicates included.
// - Duplicate targets: CTA 0 holds the claim table (F ints) in shared
//   memory; each accepted query atomicMin's its distance into it through
//   distributed shared memory, one cluster barrier later every query reads
//   its target's claim back and writes match, dist, its mask and the
//   matched keypoint's pixel and depth.  The table's fill and the match
//   count's reset are ordered before the atomics by a split cluster barrier
//   (arrive at the start, wait after the scan), and a last barrier keeps
//   CTA 0's shared memory alive until every CTA has read it.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int NWARP = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr int BIG = 10000;

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// torch.linalg.cross's rounding on the card: each component
// a_i b_j - a_k b_l as one FMA over the rounded second product (the
// contraction nvcc makes of ATen's cross kernel)
__device__ __forceinline__ void cross_rn(const float a[3], const float b[3],
                                         float c[3]) {
    c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
    c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
    c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// grid cell of a coordinate, clamped into [0, n - 1] (NaN to 0)
__device__ __forceinline__ int cell_of(float x, float inv_cell, int n) {
    const float t = fminf(fmaxf(__fmul_rn(x, inv_cell), 0.0f),
                          (float)(n - 1));
    return (int)floorf(t);
}

__global__ void __launch_bounds__(THREADS)
track_pass_kernel(const float* __restrict__ pt_pos,
                  const uint4* __restrict__ pt_desc, int n_pts,
                  const int* __restrict__ ids, int n,
                  const float* __restrict__ T, const float* __restrict__ cam,
                  const float* __restrict__ kp_uv,
                  const uint4* __restrict__ kp_desc,
                  const uint8_t* __restrict__ kp_valid,
                  const float* __restrict__ kp_depth, int F, int use_wh,
                  float w, float h, float r2, float rr, float inv_cell,
                  int gx, int gy, float ratio, int max_dist, int chunk,
                  float* __restrict__ uv_pred, uint8_t* __restrict__ vis_out,
                  int* __restrict__ vis_pt, int* __restrict__ match,
                  int* __restrict__ dist, uint8_t* __restrict__ ok_out,
                  long long* __restrict__ slot_out,
                  float* __restrict__ uv_m, float* __restrict__ depth_m,
                  int* __restrict__ n_match) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ncell = gx * gy;
    uint4* s_kdesc = reinterpret_cast<uint4*>(smem);  // 2 a keypoint
    float2* s_kuv = reinterpret_cast<float2*>(s_kdesc + 2 * F);
    int* s_kidx = reinterpret_cast<int*>(s_kuv + F);
    int* s_kcell = s_kidx + F;
    int* s_claim = s_kcell + F;
    int* s_start = s_claim + F;  // ncell + 1
    int* s_cur = s_start + ncell + 1;
    int* s_wsum = s_cur + ncell;  // NWARP

    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;

    // ---- CTA 0: the claim table and the match count, released to the
    // cluster by the first arrive
    if (rank == 0) {
        for (int b = tid; b < F; b += THREADS) s_claim[b] = BIG;
        if (tid == 0) *n_match = 0;
    }
    cluster_arrive();

    // ---- the cell grid of the valid keypoints (a counting sort)
    for (int c = tid; c < ncell; c += THREADS) s_cur[c] = 0;
    __syncthreads();
    for (int b = tid; b < F; b += THREADS) {
        int c = -1;
        if (kp_valid[b] != 0) {
            c = cell_of(kp_uv[2 * b + 1], inv_cell, gy) * gx +
                cell_of(kp_uv[2 * b], inv_cell, gx);
            atomicAdd(&s_cur[c], 1);
        }
        s_kcell[b] = c;
    }
    __syncthreads();
    {
        // exclusive scan of the counts: consecutive cells a thread
        const int per = (ncell + THREADS - 1) / THREADS;
        const int c0 = min(ncell, tid * per), c1 = min(ncell, c0 + per);
        int local = 0;
        for (int c = c0; c < c1; ++c) local += s_cur[c];
        int incl = local;
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
        }
        if (lane == 31) s_wsum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int v = lane < NWARP ? s_wsum[lane] : 0;
            for (int off = 1; off < 32; off <<= 1) {
                const int o = __shfl_up_sync(0xffffffffu, v, off);
                if (lane >= off) v += o;
            }
            if (lane < NWARP) s_wsum[lane] = v;
        }
        __syncthreads();
        int run = incl - local + (warp > 0 ? s_wsum[warp - 1] : 0);
        for (int c = c0; c < c1; ++c) {
            const int k = s_cur[c];
            s_start[c] = run;
            s_cur[c] = run;
            run += k;
        }
        if (tid == THREADS - 1) s_start[ncell] = s_wsum[NWARP - 1];
    }
    __syncthreads();
    for (int b = tid; b < F; b += THREADS) {
        const int c = s_kcell[b];
        if (c < 0) continue;
        const int pos = atomicAdd(&s_cur[c], 1);
        s_kuv[pos] = make_float2(kp_uv[2 * b], kp_uv[2 * b + 1]);
        s_kdesc[2 * pos] = kp_desc[2 * b];
        s_kdesc[2 * pos + 1] = kp_desc[2 * b + 1];
        s_kidx[pos] = b;
    }
    __syncthreads();

    // ---- each query: projection, gates, window scan, best two
    const float q0 = T[0];
    const float qv[3] = {T[1], T[2], T[3]};
    const float t[3] = {T[4], T[5], T[6]};
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    const int qa = min(n, rank * chunk), qb = min(n, qa + chunk);
    for (int q = qa + tid; q < qb; q += THREADS) {
        const int id = ids[q];
        const int safe = min(max(id, 0), n_pts - 1);
        const float X[3] = {pt_pos[3 * safe], pt_pos[3 * safe + 1],
                            pt_pos[3 * safe + 2]};
        // lie.se3_apply: X + q0 (2 qv x X) + qv x (2 qv x X) + t
        float c1[3], u1[3], c2[3], p[3];
        cross_rn(qv, X, c1);
        for (int i = 0; i < 3; ++i) u1[i] = __fmul_rn(2.0f, c1[i]);
        cross_rn(qv, u1, c2);
        for (int i = 0; i < 3; ++i) {
            p[i] = __fadd_rn(__fadd_rn(__fadd_rn(X[i], __fmul_rn(q0, u1[i])),
                                       c2[i]),
                             t[i]);
        }
        // cameras.project_pinhole
        const float z = p[2];
        const float iz = __frcp_rn(fabsf(z) < 1e-9f ? 1e-9f : z);
        const float u = __fadd_rn(__fmul_rn(__fmul_rn(fx, p[0]), iz), cx);
        const float v = __fadd_rn(__fmul_rn(__fmul_rn(fy, p[1]), iz), cy);
        bool vis = z > 0.05f && id >= 0;
        if (use_wh) vis = vis && u >= 0.0f && u < w && v >= 0.0f && v < h;
        if (uv_pred != nullptr) {
            uv_pred[2 * q] = u;
            uv_pred[2 * q + 1] = v;
            vis_out[q] = vis;
        }
        vis_pt[q] = vis ? id : -1;
        int best = BIG, second = BIG, best_i = 0;
        if (vis) {
            const uint4 da = pt_desc[2 * safe], db = pt_desc[2 * safe + 1];
            const int lx = cell_of(__fsub_rn(u, rr), inv_cell, gx);
            const int hx = cell_of(__fadd_rn(u, rr), inv_cell, gx);
            const int ly = cell_of(__fsub_rn(v, rr), inv_cell, gy);
            const int hy = cell_of(__fadd_rn(v, rr), inv_cell, gy);
            for (int gyi = ly; gyi <= hy; ++gyi) {
                const int end = s_start[gyi * gx + hx + 1];
                for (int pos = s_start[gyi * gx + lx]; pos < end; ++pos) {
                    const float2 kb = s_kuv[pos];
                    const float du = __fsub_rn(u, kb.x);
                    const float dv = __fsub_rn(v, kb.y);
                    if (!(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <=
                          r2)) {
                        continue;
                    }
                    const uint4 ea = s_kdesc[2 * pos];
                    const uint4 eb = s_kdesc[2 * pos + 1];
                    const int d = __popc(da.x ^ ea.x) + __popc(da.y ^ ea.y) +
                                  __popc(da.z ^ ea.z) + __popc(da.w ^ ea.w) +
                                  __popc(db.x ^ eb.x) + __popc(db.y ^ eb.y) +
                                  __popc(db.z ^ eb.z) + __popc(db.w ^ eb.w);
                    const int b = s_kidx[pos];
                    if (d < best || (d == best && b < best_i)) {
                        second = best;
                        best = d;
                        best_i = b;
                    } else if (d < second) {
                        second = d;
                    }
                }
            }
        }
        const bool ok = best <= max_dist &&
                        (float)best <= __fmul_rn(ratio, (float)second);
        match[q] = ok ? best_i : -1;  // provisional, before the claims
        dist[q] = best;
    }

    // ---- claims: after CTA 0's fill, before anyone reads them back
    int* claim = cl.map_shared_rank(s_claim, 0);
    cluster_wait();
    for (int q = qa + tid; q < qb; q += THREADS) {
        const int m = match[q];
        if (m >= 0) atomicMin(&claim[m], dist[q]);
    }
    cluster_arrive();
    cluster_wait();

    // ---- resolution and the gathers
    int cnt = 0;
    for (int q = qa + tid; q < qb; q += THREADS) {
        int m = match[q];
        const int d = dist[q];
        const bool ok = m >= 0 && d <= claim[m];
        m = ok ? m : -1;
        match[q] = m;
        dist[q] = ok ? d : BIG;
        ok_out[q] = ok;
        const int slot = ok ? m : 0;
        slot_out[q] = slot;
        uv_m[2 * q] = kp_uv[2 * slot];
        uv_m[2 * q + 1] = kp_uv[2 * slot + 1];
        if (depth_m != nullptr) depth_m[q] = kp_depth[slot];
        cnt += ok ? 1 : 0;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0 && cnt > 0) atomicAdd(n_match, cnt);
    // CTA 0's claim table stays alive until every CTA has read it
    cluster_arrive();
    cluster_wait();
}

}  // namespace

// pt_pos: (n_pts, 3) f32, pt_desc: (n_pts, 32) u8 (16-byte aligned);
// ids: (n,) i32 local point ids, -1 padded; T: (7,) pose [q, t]; cam: (4,)
// [fx, fy, cx, cy]; kp_uv (F, 2) f32, kp_desc (F, 32) u8 (16-byte
// aligned), kp_valid (F,) u8, kp_depth (F,) f32 or null: the frame's
// keypoints; use_wh, w, h: the image-bound gate; r2: the window's squared
// radius (float32), rr: the radius plus the bounding box's margin;
// inv_cell, gx, gy: the cell grid; C CTAs of chunk queries, smem bytes
// each (track_pass_plan).  Writes uv_pred (n, 2) and vis (n,) u8 (when
// uv_pred is given), vis_pt (n,), match (n,) (-1 none), dist (n,) (10000
// none), ok (n,) u8, slot (n,) i64 (max(match, 0)), uv_m (n, 2), depth_m
// (n,) (when kp_depth is given) and n_match ().
VSG_API int vsg_track_pass(const float* pt_pos, const uint8_t* pt_desc,
                           int n_pts, const int* ids, int n, const float* T,
                           const float* cam, const float* kp_uv,
                           const uint8_t* kp_desc, const uint8_t* kp_valid,
                           const float* kp_depth, int F, int use_wh, float w,
                           float h, float r2, float rr, float inv_cell,
                           int gx, int gy, float ratio, int max_dist, int C,
                           int chunk, int smem, float* uv_pred,
                           uint8_t* vis, int* vis_pt, int* match, int* dist,
                           uint8_t* ok, long long* slot, float* uv_m,
                           float* depth_m, int* n_match,
                           cudaStream_t stream) {
    if (C < 1 || C > MAX_CLUSTER || (long long)C * chunk < n || n_pts < 1 ||
        gx < 1 || gy < 1) {
        return (int)cudaErrorInvalidValue;
    }
    static int smem_set = 0;
    cudaError_t err;
    if (smem > smem_set) {
        err = cudaFuncSetAttribute(track_pass_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
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
    err = cudaLaunchKernelEx(
        &cfg, track_pass_kernel, pt_pos,
        reinterpret_cast<const uint4*>(pt_desc), n_pts, ids, n, T, cam, kp_uv,
        reinterpret_cast<const uint4*>(kp_desc), kp_valid, kp_depth, F, use_wh,
        w, h, r2, rr, inv_cell, gx, gy, ratio, max_dist, chunk, uv_pred, vis,
        vis_pt, match, dist, ok, slot, uv_m, depth_m, n_match);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
