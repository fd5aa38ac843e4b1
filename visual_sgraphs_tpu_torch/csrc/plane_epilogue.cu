// K14: per-detection statistics of the plane detector.
//
// Replaces the epilogue of visual_sgraphs_tpu/scenegraph/manager.py::
// detect_planes_from_depth (manager.py:254-299): the (n_det, M) member
// mask, member count, world centroid, confidence-weighted class votes,
// Gij quadric and the .at[].max voxel-key rows.  The JAX version builds
// (n_det, M) and (n_det, M, 3) intermediates and an einsum per statistic.
//
// What bounds it here: bytes.  One read of the strided cloud (M = 19,200
// points: xyz, valid, label, confidence, ~330 KB) and a few KB of output;
// ~60 flops per point and detection.  Well under a microsecond of HBM
// time at these sizes, so it is latency-bound.
//
// Design: kernel 1, one thread per point, handles all detections: it
// transforms the point to the world frame, tests membership against each
// camera-frame plane, and for members adds 17 sums (count, centroid 3,
// votes 3, the 10 distinct quadric entries) by warp shuffles and shared-
// memory atomics, then one global atomicAdd per sum and block; the member
// point, projected onto its world plane, is quantised and hashed and its
// key atomicMax'ed into the detection's (V,) row, which is the reference's
// duplicate-index .at[].max.  The world transform, the plane distances and
// the projection use correctly rounded operations in the plain version's
// order, so members and keys agree bitwise.  Kernel 2, one block, divides
// the sums (centroid by count, votes by their total, quadric by the
// confidence mass).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSUM = 17;
constexpr int MAX_DET = 8;

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

__device__ __forceinline__ int voxel_coord(float x, float inv_vox) {
    const int i = (int)floorf(__fmul_rn(x, inv_vox)) + 512;
    return min(max(i, 0), 1023);
}

__global__ void __launch_bounds__(THREADS)
epilogue_accumulate(const float* __restrict__ pts,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ labels,
                    const float* __restrict__ conf,
                    const float* __restrict__ coeffs_c,
                    const float* __restrict__ coeffs_w,
                    const float* __restrict__ T, int M, int D, float thresh,
                    float inv_vox, int V, float* __restrict__ acc,
                    int* __restrict__ vox) {
    __shared__ float s_acc[MAX_DET * NSUM];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    for (int k = tid; k < D * NSUM; k += THREADS) s_acc[k] = 0.0f;
    __syncthreads();
    const int i = blockIdx.x * THREADS + tid;
    bool ok = false;
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, w0 = 0.f, w1 = 0.f, w2 = 0.f,
          cf = 0.f;
    int lab = -1;
    if (i < M) {
        ok = valid[i] != 0;
        p0 = pts[3 * i];
        p1 = pts[3 * i + 1];
        p2 = pts[3 * i + 2];
        cf = conf[i];
        lab = labels[i];
        // world point: p + qw*uv + qv x uv + t, uv = 2 qv x p
        const float qw = T[0], qx = T[1], qy = T[2], qz = T[3];
        const float u0 = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(qy, p2),
                                                   __fmul_rn(qz, p1)));
        const float u1 = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(qz, p0),
                                                   __fmul_rn(qx, p2)));
        const float u2 = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(qx, p1),
                                                   __fmul_rn(qy, p0)));
        const float e0 = __fsub_rn(__fmul_rn(qy, u2), __fmul_rn(qz, u1));
        const float e1 = __fsub_rn(__fmul_rn(qz, u0), __fmul_rn(qx, u2));
        const float e2 = __fsub_rn(__fmul_rn(qx, u1), __fmul_rn(qy, u0));
        w0 = __fadd_rn(__fadd_rn(__fadd_rn(p0, __fmul_rn(qw, u0)), e0), T[4]);
        w1 = __fadd_rn(__fadd_rn(__fadd_rn(p1, __fmul_rn(qw, u1)), e1), T[5]);
        w2 = __fadd_rn(__fadd_rn(__fadd_rn(p2, __fmul_rn(qw, u2)), e2), T[6]);
    }
    for (int d = 0; d < D; ++d) {
        const float* cc = coeffs_c + 4 * d;
        bool member = false;
        if (ok) {
            const float dist = fabsf(__fadd_rn(
                dot3_rn(cc[0], cc[1], cc[2], p0, p1, p2), cc[3]));
            member = dist < thresh;
        }
        float v[NSUM];
#pragma unroll
        for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
        if (member) {
            const float mw = cf;
            v[0] = 1.0f;
            v[1] = w0;
            v[2] = w1;
            v[3] = w2;
            v[4] = lab == 0 ? mw : 0.0f;
            v[5] = lab == 1 ? mw : 0.0f;
            v[6] = lab == 2 ? mw : 0.0f;
            v[7] = mw * p0 * p0;
            v[8] = mw * p0 * p1;
            v[9] = mw * p0 * p2;
            v[10] = mw * p0;
            v[11] = mw * p1 * p1;
            v[12] = mw * p1 * p2;
            v[13] = mw * p1;
            v[14] = mw * p2 * p2;
            v[15] = mw * p2;
            v[16] = mw;
            // surface-membership voxel key of the projection onto the
            // world plane
            const float* cw = coeffs_w + 4 * d;
            const float sd = __fadd_rn(dot3_rn(cw[0], cw[1], cw[2], w0, w1, w2),
                                       cw[3]);
            const int ix = voxel_coord(__fsub_rn(w0, __fmul_rn(sd, cw[0])),
                                       inv_vox);
            const int iy = voxel_coord(__fsub_rn(w1, __fmul_rn(sd, cw[1])),
                                       inv_vox);
            const int iz = voxel_coord(__fsub_rn(w2, __fmul_rn(sd, cw[2])),
                                       inv_vox);
            const int key = (ix << 20) | (iy << 10) | iz;
            const unsigned slot = (((unsigned)key * 2654435761u) >> 16) %
                                  (unsigned)V;
            atomicMax(&vox[d * V + slot], key);
        }
#pragma unroll
        for (int k = 0; k < NSUM; ++k) {
            const float s = vsg_warp_sum(v[k]);
            if (lane == 0 && s != 0.0f) atomicAdd(&s_acc[d * NSUM + k], s);
        }
    }
    __syncthreads();
    for (int k = tid; k < D * NSUM; k += THREADS) {
        if (s_acc[k] != 0.0f) atomicAdd(&acc[k], s_acc[k]);
    }
}

__global__ void epilogue_finalize(const float* __restrict__ acc, int D,
                                  float* __restrict__ npts,
                                  float* __restrict__ centroid,
                                  float* __restrict__ votes,
                                  float* __restrict__ quad) {
    const int d = threadIdx.x;
    if (d >= D) return;
    const float* a = acc + d * NSUM;
    npts[d] = a[0];
    const float den = fmaxf(a[0], 1.0f);
    for (int k = 0; k < 3; ++k) centroid[3 * d + k] = a[1 + k] / den;
    const float vden = fmaxf((a[4] + a[5]) + a[6], 1.0f);
    for (int k = 0; k < 3; ++k) votes[3 * d + k] = a[4 + k] / vden;
    const float qden = fmaxf(a[16], 1.0f);
    // distinct entries (00 01 02 03 11 12 13 22 23 33)
    const int row[10] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
    const int col[10] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};
    float* q = quad + 16 * d;
    for (int k = 0; k < 10; ++k) {
        const float v = a[7 + k] / qden;
        q[4 * row[k] + col[k]] = v;
        q[4 * col[k] + row[k]] = v;
    }
}

}  // namespace

// pts (M, 3) camera frame, valid (M,) u8, labels (M,) i32, conf (M,),
// coeffs_c / coeffs_w (D, 4) camera / world planes, T (7,) T_wc; all f32
// unless stated.  thresh: member distance; inv_vox: 1/0.3 rounded to f32.
// Outputs npts (D,), centroid (D, 3), votes (D, 3), quad (D, 4, 4),
// vox (D, V) i32 (-1 = empty).  Scratch acc (D, 17) f32, zeroed here.
VSG_API int vsg_plane_epilogue(const float* pts, const uint8_t* valid,
                               const int* labels, const float* conf,
                               const float* coeffs_c, const float* coeffs_w,
                               const float* T, int M, int D, float thresh,
                               float inv_vox, int V, float* acc, float* npts,
                               float* centroid, float* votes, float* quad,
                               int* vox, cudaStream_t stream) {
    if (D > MAX_DET) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * NSUM * D,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(vox, 0xff, sizeof(int) * D * V, stream);
    if (err != cudaSuccess) return (int)err;
    if (M > 0) {
        epilogue_accumulate<<<(M + THREADS - 1) / THREADS, THREADS, 0,
                              stream>>>(pts, valid, labels, conf, coeffs_c,
                                        coeffs_w, T, M, D, thresh, inv_vox,
                                        V, acc, vox);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    epilogue_finalize<<<1, 32, 0, stream>>>(acc, D, npts, centroid, votes,
                                            quad);
    return (int)cudaGetLastError();
}
