// K25: the tracking scan's per-frame bookkeeping, one launch a frame.
//
// Replaces what visual_sgraphs_tpu/slam/tracking.py:478-510 computes
// inside lax.scan's step after the two tracking attempts, and the inlier
// tail of its _track_frame_impl (:319-329):
//   keep_a = ok_a & inliers_a, n_inliers_a = sum keep_a (each attempt),
//   need_retry = n_inliers_1 < min_inliers, the retry's result where it
//   holds, else the first attempt's,
//   slot_pt = scatter-max of the kept ids over the keypoint slots (-1
//   elsewhere), vis_pt, n_matches, n_inliers, n_local_pts,
//   accepted = n_inliers >= min_inliers,
//   pose_sel = accepted ? normalize(pose) : T_prev,
//   vel_sel = accepted ? normalize(normalize(pose) T_prev^-1) : identity,
//   T_rel = normalize(pose_sel T_kf^-1),
//   the packed row [n_matches, n_inliers, n_local_pts, need_retry],
// written straight into row i of the batch's (B, ...) outputs, and the
// next frame's prediction normalize(vel_sel pose_sel) with its T_prev and
// velocity into the scan's small state buffer, which the next frame's
// tracking passes and pose solves read.  Three entries:
// - vsg_scan_prologue: the first frame's state from the batch's T_last
//   and velocity (one thread);
// - vsg_scan_epilogue: a frame's step, as above;
// - vsg_inlier_tail: one attempt's tail alone (slot_pt, n_inliers and the
//   packed row with a given retry flag) for the serial frame step, whose
//   retry the host decides.
//
// What bounds it here: latency.  The reads are two attempts' 4096-entry
// masks, slots and visible ids (~100 KB); the work is two block sums, one
// scatter-max over 1000 slots in shared memory and ~300 flops of pose
// algebra on one thread.
//
// Design: one block of 1024 threads.  The two keep counts by warp sums,
// then the chosen attempt's scatter-max by shared-memory atomicMax (an
// integer max: the result does not depend on the order) and the copies,
// while thread 0 runs the pose algebra.  The pose algebra rounds op for
// op as the plain torch chain does on the card (__fmul_rn / __fadd_rn,
// so nvcc contracts nothing into an FMA, and torch.linalg.cross's one
// FMA over the rounded second product); every integer and decision is
// exact.
#include "common.cuh"

#include "lie_rn.cuh"

namespace {

constexpr int THREADS = 1024;

// One attempt's fine tracking pass and pose solve
struct Attempt {
    const uint8_t* ok;  // (N,) matched
    const int64_t* slot;  // (N,) the matched keypoint slot (0 unmatched)
    const int* vis;  // (N,) the visible points' ids, else -1
    const int* n_match;  // () matches
    const float* T;  // (7,) the solved pose
    const uint8_t* inl;  // (N,) the solve's inliers
};

// The block's sum of one int a thread (every thread gets it); ``red``
// holds 32 ints of shared scratch
__device__ int block_sum(int x, int* red) {
    for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = x;
    __syncthreads();
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
    __syncthreads();
    return s;
}

// the kept matches of an attempt
__device__ int count_kept(const Attempt& a, int N, int* red) {
    int c = 0;
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        c += (a.ok[e] != 0 && a.inl[e] != 0) ? 1 : 0;
    }
    return block_sum(c, red);
}

// slot_out[0..F) = scatter-max of the kept ids (-1 elsewhere), through
// shared memory
__device__ void scatter_kept(const Attempt& a, const int* ids, int N, int F,
                             int* slot_sh, int* slot_out) {
    for (int s = threadIdx.x; s < F; s += blockDim.x) slot_sh[s] = -1;
    __syncthreads();
    for (int e = threadIdx.x; e < N; e += blockDim.x) {
        if (a.ok[e] != 0 && a.inl[e] != 0) {
            atomicMax(&slot_sh[a.slot[e]], ids[e]);
        }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < F; s += blockDim.x) slot_out[s] = slot_sh[s];
}

__global__ void __launch_bounds__(THREADS)
scan_epilogue_kernel(Attempt a1, Attempt a2, const int* __restrict__ ids,
                     const int* __restrict__ n_pts, int N, int F,
                     const float* __restrict__ kf_base, int min_inliers,
                     float* __restrict__ state, float* __restrict__ pose_row,
                     int* __restrict__ slot_row, int* __restrict__ vis_row,
                     int* __restrict__ n_match_out,
                     int* __restrict__ n_inl_out,
                     int* __restrict__ n_local_out,
                     float* __restrict__ T_rel_row,
                     float* __restrict__ packed_row) {
    extern __shared__ int slot_sh[];
    __shared__ int red[32];
    const int n1 = count_kept(a1, N, red);
    const int n2 = count_kept(a2, N, red);
    const bool retry = n1 < min_inliers;
    const Attempt& a = retry ? a2 : a1;
    const int n_inl = retry ? n2 : n1;
    scatter_kept(a, ids, N, F, slot_sh, slot_row);
    for (int e = threadIdx.x; e < N; e += blockDim.x) vis_row[e] = a.vis[e];
    if (threadIdx.x != 0) return;
    const int n_match = a.n_match[0];
    *n_match_out = n_match;
    *n_inl_out = n_inl;
    *n_local_out = n_pts[0];
    packed_row[0] = (float)n_match;
    packed_row[1] = (float)n_inl;
    packed_row[2] = (float)n_pts[0];
    packed_row[3] = retry ? 1.0f : 0.0f;
    float pose[7], T_prev[7], pose_sel[7], vel_sel[7], T_pred[7];
    for (int k = 0; k < 7; ++k) {
        pose[k] = a.T[k];
        T_prev[k] = state[7 + k];
        pose_row[k] = pose[k];
    }
    se3_normalize_rn(pose);
    const bool accepted = n_inl >= min_inliers;
    if (accepted) {
        for (int k = 0; k < 7; ++k) pose_sel[k] = pose[k];
        mul_inv_normalize(pose, T_prev, vel_sel);
    } else {
        for (int k = 0; k < 7; ++k) {
            pose_sel[k] = T_prev[k];
            vel_sel[k] = k == 0 ? 1.0f : 0.0f;
        }
    }
    mul_inv_normalize(pose_sel, kf_base, T_rel_row);
    mul_normalize(vel_sel, pose_sel, T_pred);
    for (int k = 0; k < 7; ++k) {
        state[k] = T_pred[k];
        state[7 + k] = pose_sel[k];
        state[14 + k] = vel_sel[k];
    }
}

__global__ void __launch_bounds__(THREADS)
inlier_tail_kernel(Attempt a, const int* __restrict__ ids,
                   const int* __restrict__ n_pts, int N, int F, int retried,
                   int* __restrict__ slot_pt, int* __restrict__ n_inl_out,
                   float* __restrict__ packed) {
    extern __shared__ int slot_sh[];
    __shared__ int red[32];
    const int n_inl = count_kept(a, N, red);
    scatter_kept(a, ids, N, F, slot_sh, slot_pt);
    if (threadIdx.x != 0) return;
    *n_inl_out = n_inl;
    packed[0] = (float)a.n_match[0];
    packed[1] = (float)n_inl;
    packed[2] = (float)n_pts[0];
    packed[3] = retried ? 1.0f : 0.0f;
}

__global__ void scan_prologue_kernel(const float* __restrict__ T_last,
                                     const float* __restrict__ vel,
                                     float* __restrict__ state) {
    float T[7], v[7], T_pred[7];
    for (int k = 0; k < 7; ++k) {
        T[k] = T_last[k];
        v[k] = vel[k];
    }
    mul_normalize(v, T, T_pred);
    for (int k = 0; k < 7; ++k) {
        state[k] = T_pred[k];
        state[7 + k] = T[k];
        state[14 + k] = v[k];
    }
}

// the slot table's shared memory; past the 48 KB default the attribute is
// raised once a process
template <typename K>
cudaError_t smem_for(K kernel, size_t bytes, size_t& set) {
    if (bytes > 48 * 1024 && bytes > set) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return err;
        set = bytes;
    }
    return cudaSuccess;
}

}  // namespace

// T_last (7,), vel (7,) f32 -> state (21,) = [normalize(vel T_last),
// T_last, vel]
VSG_API int vsg_scan_prologue(const float* T_last, const float* vel,
                              float* state, cudaStream_t stream) {
    scan_prologue_kernel<<<1, 1, 0, stream>>>(T_last, vel, state);
    return (int)cudaGetLastError();
}

// Attempt a (a = 1 the prediction's, 2 the wide retry's): ok (N,) u8,
// slot (N,) i64, vis (N,) i32, n_match () i32, T (7,) f32, inliers (N,)
// u8.  ids (N,) i32 the local table, n_pts () i32 its size, F keypoint
// slots, kf_base (7,) the reference keyframe's pose, state (21,) [T_pred,
// T_prev, vel] read and then written with the next frame's.  The outputs
// are row pointers into the batch's tables: pose (7,), slot_pt (F,),
// vis_pt (N,), n_matches, n_inliers, n_local_pts (each one i32), T_rel
// (7,), packed (4,).
VSG_API int vsg_scan_epilogue(
    const uint8_t* ok1, const int64_t* slot1, const int* vis1,
    const int* nm1, const float* T1, const uint8_t* inl1, const uint8_t* ok2,
    const int64_t* slot2, const int* vis2, const int* nm2, const float* T2,
    const uint8_t* inl2, const int* ids, const int* n_pts, int N, int F,
    const float* kf_base, int min_inliers, float* state, float* pose_row,
    int* slot_row, int* vis_row, int* n_match_out, int* n_inl_out,
    int* n_local_out, float* T_rel_row, float* packed_row,
    cudaStream_t stream) {
    static size_t set = 0;
    const size_t smem = sizeof(int) * (size_t)F;
    const cudaError_t err = smem_for(scan_epilogue_kernel, smem, set);
    if (err != cudaSuccess) return (int)err;
    const Attempt a1{ok1, slot1, vis1, nm1, T1, inl1};
    const Attempt a2{ok2, slot2, vis2, nm2, T2, inl2};
    scan_epilogue_kernel<<<1, THREADS, smem, stream>>>(
        a1, a2, ids, n_pts, N, F, kf_base, min_inliers, state, pose_row,
        slot_row, vis_row, n_match_out, n_inl_out, n_local_out, T_rel_row,
        packed_row);
    return (int)cudaGetLastError();
}

// One attempt (as above, without vis and T) -> slot_pt (F,) i32, n_inliers
// () i32, packed (4,) f32 [n_matches, n_inliers, n_pts, retried]
VSG_API int vsg_inlier_tail(const uint8_t* ok, const int64_t* slot,
                            const uint8_t* inl, const int* ids,
                            const int* n_match, const int* n_pts, int N,
                            int F, int retried, int* slot_pt, int* n_inl,
                            float* packed, cudaStream_t stream) {
    static size_t set = 0;
    const size_t smem = sizeof(int) * (size_t)F;
    const cudaError_t err = smem_for(inlier_tail_kernel, smem, set);
    if (err != cudaSuccess) return (int)err;
    const Attempt a{ok, slot, nullptr, n_match, nullptr, inl};
    inlier_tail_kernel<<<1, THREADS, smem, stream>>>(
        a, ids, n_pts, N, F, retried, slot_pt, n_inl, packed);
    return (int)cudaGetLastError();
}
