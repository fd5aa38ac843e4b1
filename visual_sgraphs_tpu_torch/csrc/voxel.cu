// K12: strided depth backprojection + hash-scatter voxel downsample.
//
// Replaces visual_sgraphs_tpu/scenegraph/pointcloud.py::backproject_depth
// and ::voxel_downsample (with the jnp.nonzero(size=n_out) compaction of
// pointcloud.py:72), as detect_planes_from_depth calls them.
//
// What bounds it here: bytes.  The work is one read of the strided depth
// (and class / confidence) pixels, M = (H/4)(W/4) = 19,200 at 640x480,
// one write of the (M, 3) cloud + labels, ~20 atomics per valid point
// into a (4 * n_out + 1)-slot table (8,193 slots, 160 KB) that stays in
// L2, and one pass over the table: about 1 MB in all, well under a
// microsecond of HBM time, so launch latency dominates.
//
// Design: kernel 1, one thread per strided pixel, backprojects with
// correctly rounded operations (no contraction, so the voxel keys match
// the plain version bitwise), hashes the voxel with the reference's
// int32 multiply-xor and a remainder that follows the divisor's sign
// (jnp's %, not C's), and atomicAdds x, y, z, weight and count into the
// slot.  Kernel 2, one block, compacts the occupied slots in ascending
// slot order with a block-wide prefix sum (no torch.nonzero, which
// synchronises with the host) and writes the first n_out centroids and
// mean weights; rows past the occupied count repeat slot 0, as the
// reference's fill_value=-1 + maximum(idx, 0) gather does.  Centroids
// differ from the plain version only by the order of the atomic sums.
#include "common.cuh"

namespace {

constexpr float MIN_DEPTH = 0.2f;
constexpr float MAX_DEPTH = 8.0f;
constexpr int COMPACT_THREADS = 1024;

__global__ void depth_scatter(const float* __restrict__ depth,
                              const int* __restrict__ sem,
                              const float* __restrict__ conf_img,
                              const float* __restrict__ cam_K, int w,
                              int stride, int ws, int M, float inv_voxel,
                              int table, float* __restrict__ pts,
                              uint8_t* __restrict__ valid,
                              int* __restrict__ labels,
                              float* __restrict__ conf,
                              float* __restrict__ acc,
                              int* __restrict__ counts) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    const int r = (i / ws) * stride;
    const int c = (i % ws) * stride;
    const int pix = r * w + c;
    const float d = depth[pix];
    const float x = __fdiv_rn(__fsub_rn((float)c, cam_K[2]), cam_K[0]);
    const float y = __fdiv_rn(__fsub_rn((float)r, cam_K[3]), cam_K[1]);
    const float px = __fmul_rn(x, d);
    const float py = __fmul_rn(y, d);
    const float pz = d;
    const bool ok = d > MIN_DEPTH && d < MAX_DEPTH;
    const float wt = conf_img != nullptr ? conf_img[pix] : 1.0f;
    pts[3 * i] = px;
    pts[3 * i + 1] = py;
    pts[3 * i + 2] = pz;
    valid[i] = ok ? 1 : 0;
    labels[i] = sem != nullptr ? sem[pix] : -1;
    conf[i] = wt;
    if (!ok) return;
    const unsigned kx = (unsigned)(int)floorf(__fmul_rn(px, inv_voxel));
    const unsigned ky = (unsigned)(int)floorf(__fmul_rn(py, inv_voxel));
    const unsigned kz = (unsigned)(int)floorf(__fmul_rn(pz, inv_voxel));
    const int hv = (int)((kx * 73856093u) ^ (ky * 19349663u) ^
                         (kz * 83492791u));
    int slot = hv % table;
    if (slot < 0) slot += table;
    atomicAdd(&acc[4 * slot], px);
    atomicAdd(&acc[4 * slot + 1], py);
    atomicAdd(&acc[4 * slot + 2], pz);
    atomicAdd(&acc[4 * slot + 3], wt);
    atomicAdd(&counts[slot], 1);
}

__device__ __forceinline__ void write_row(const float* __restrict__ acc,
                                          const int* __restrict__ counts,
                                          int slot, int row, bool ok,
                                          float* __restrict__ cloud,
                                          uint8_t* __restrict__ cvalid,
                                          float* __restrict__ cweight) {
    const float den = (float)max(counts[slot], 1);
    cloud[3 * row] = __fdiv_rn(acc[4 * slot], den);
    cloud[3 * row + 1] = __fdiv_rn(acc[4 * slot + 1], den);
    cloud[3 * row + 2] = __fdiv_rn(acc[4 * slot + 2], den);
    cweight[row] = __fdiv_rn(acc[4 * slot + 3], den);
    cvalid[row] = ok ? 1 : 0;
}

// One block: exclusive prefix sum of per-thread occupied counts over
// contiguous slot chunks, then each thread writes its chunk's rows.
__global__ void voxel_compact(const float* __restrict__ acc,
                              const int* __restrict__ counts, int table,
                              int n_out, float* __restrict__ cloud,
                              uint8_t* __restrict__ cvalid,
                              float* __restrict__ cweight) {
    __shared__ int warp_total[COMPACT_THREADS / 32];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int n_warps = blockDim.x >> 5;
    const int chunk = (table + blockDim.x - 1) / blockDim.x;
    const int lo = min(t * chunk, table);
    const int hi = min(lo + chunk, table);
    int cnt = 0;
    for (int s = lo; s < hi; ++s) cnt += counts[s] >= 1;
    int incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int v = lane < n_warps ? warp_total[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += u;
        }
        if (lane < n_warps) warp_total[lane] = v;  // inclusive over warps
    }
    __syncthreads();
    int pos = incl - cnt + (warp > 0 ? warp_total[warp - 1] : 0);
    for (int s = lo; s < hi && pos < n_out; ++s) {
        if (counts[s] >= 1) {
            write_row(acc, counts, s, pos, true, cloud, cvalid, cweight);
            ++pos;
        }
    }
    const int total = min(warp_total[n_warps - 1], n_out);
    for (int row = total + t; row < n_out; row += blockDim.x) {
        write_row(acc, counts, 0, row, false, cloud, cvalid, cweight);
    }
}

}  // namespace

// depth (H, W) f32; sem (H, W) i32 or NULL (all -1); conf_img (H, W) f32
// or NULL (all 1); cam_K (4,) f32 [fx fy cx cy] on the device.  inv_voxel
// is 1/voxel rounded to f32.  Outputs: pts (M, 3), valid (M,) u8, labels
// (M,), conf (M,), cloud (n_out, 3), cvalid (n_out,) u8, cweight (n_out,).
// Scratch: acc (table + 1, 4) f32 and counts (table + 1,) i32, zeroed here.
VSG_API int vsg_depth_cloud(const float* depth, const int* sem,
                            const float* conf_img, const float* cam_K, int h,
                            int w, int stride, float inv_voxel, int table,
                            int n_out, float* pts, uint8_t* valid,
                            int* labels, float* conf, float* acc,
                            int* counts, float* cloud, uint8_t* cvalid,
                            float* cweight, cudaStream_t stream) {
    const int hs = h / stride;
    const int ws = w / stride;
    const int M = hs * ws;
    cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * 4 * (table + 1),
                                      stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(counts, 0, sizeof(int) * (table + 1), stream);
    if (err != cudaSuccess) return (int)err;
    if (M > 0) {
        depth_scatter<<<(M + 255) / 256, 256, 0, stream>>>(
            depth, sem, conf_img, cam_K, w, stride, ws, M, inv_voxel, table,
            pts, valid, labels, conf, acc, counts);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    voxel_compact<<<1, COMPACT_THREADS, 0, stream>>>(acc, counts, table, n_out,
                                                     cloud, cvalid, cweight);
    return (int)cudaGetLastError();
}
