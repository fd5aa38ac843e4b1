// K17: free-space carving (K17a) and the free grid's 6-connected
// components (K17b), the voxblox skeleton clusters of the free-space room
// method.
//
// K17a replaces visual_sgraphs_tpu/scenegraph/freespace.py:41::
// accumulate_freespace: every ``stride``-th pixel's viewing ray is sampled
// at 5 interior fractions of its depth (where z > 0.3), the samples are
// mapped to the world by T_wc and their voxels of a (G, G, G) bool grid
// are set.  What bounds it here: bytes, and little of them (60 x 80 depth
// samples read at 640x480, at most G^3 bytes written); it is one launch of
// 24000 threads, latency-bound.  Design: one thread per (pixel, fraction);
// each in-range sample stores a plain 1 byte, race-free because the
// reference's scatter-max of booleans only ever writes True.  The voxel
// index must equal the plain twin's and the reference's bit for bit, so
// every operation is an explicitly rounded intrinsic in the reference's
// order, where nvcc would otherwise contract at will: XLA's CPU build
// rotates a sample as R0 p0, then two fused multiply-adds, then adds the
// centre (measured against its output), so that chain is __fmaf_rn here
// and the rest __fmul_rn / __fadd_rn / __fdiv_rn.  The rotation and camera
// centre come in from the caller, who forms them with the twin's ops.
//
// K17b replaces visual_sgraphs_tpu/scenegraph/freespace.py:75::
// freespace_cluster_centers: 48 synchronous sweeps of 6-neighbour
// min-label propagation without wrap-around, the component sizes, the 4
// largest (lax.top_k: the lower label first on ties) and their centroids.
// What bounds it: latency.  It reads 32 KB and writes 64 bytes (and, for
// the checks only, the labels), but the sweeps are a chain of 48
// dependent passes over the grid, ~11 M integer operations in one block.  Design: one block of 1024 threads holds the
// labels in dynamic shared memory.  The sweeps are Jacobi, as the
// reference's (each reads the previous sweep's labels): an in-place
// Gauss-Seidel update converges faster and labels any component longer
// than 48 voxel steps differently.  Two int32 label buffers (256 KB) do not
// fit a block's 227 KB, but the labels do fit uint16 (BIG = G^3 + 1 =
// 32769 at G = 32), so two uint16 buffers take 128 KB.  The final labels
// then sit in the first 64 KB and the (G^3) int32 histogram in the next
// 128 KB (shared atomics).  The top-k is a block arg-max per cluster.  The
// centroids' coordinate sums are integers below 2^24, summed exactly as
// integers; the quotient is rounded alone and the affine map to the world
// (ctr + 0.5) * voxel + origin with one fused multiply-add, as XLA's CPU
// build rounds the reference's (measured against its output).
#include "common.cuh"

namespace {

__constant__ float kFracs[5] = {0.2f, 0.4f, 0.55f, 0.7f, 0.85f};

__global__ void freespace_carve_kernel(const float* __restrict__ depth,
                                       int h, int w, int stride, int hs,
                                       int ws, const float* __restrict__ K,
                                       const float* __restrict__ R,
                                       const float* __restrict__ C,
                                       const float* __restrict__ origin,
                                       float voxel, int G,
                                       uint8_t* __restrict__ grid) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int per = hs * ws;
    if (t >= 5 * per) return;
    const int f = t / per, rc = t % per;
    const int r = rc / ws, c = rc % ws;
    const float z = depth[(size_t)(r * stride) * w + c * stride];
    if (!(z > 0.3f)) return;
    // camera-frame sample: ray (u - cx) / fx, (v - cy) / fy, 1 times
    // z * frac (the reference's order: the depth fraction first)
    const float rx = __fdiv_rn(__fsub_rn((float)(c * stride), K[2]), K[0]);
    const float ry = __fdiv_rn(__fsub_rn((float)(r * stride), K[3]), K[1]);
    const float s = __fmul_rn(z, kFracs[f]);
    const float p[3] = {__fmul_rn(rx, s), __fmul_rn(ry, s), s};
    int idx[3];
    for (int i = 0; i < 3; ++i) {
        const float pw = __fadd_rn(
            __fmaf_rn(R[3 * i + 2], p[2],
                      __fmaf_rn(R[3 * i + 1], p[1],
                                __fmul_rn(R[3 * i], p[0]))),
            C[i]);
        const float q = floorf(__fdiv_rn(__fsub_rn(pw, origin[i]), voxel));
        if (!(q >= 0.0f && q < (float)G)) return;
        idx[i] = (int)q;
    }
    grid[((size_t)idx[0] * G + idx[1]) * G + idx[2]] = 1;
}

__device__ __forceinline__ uint16_t umin16(uint16_t a, uint16_t b) {
    return b < a ? b : a;
}

constexpr int kThreads = 1024;
constexpr int kMaxClusters = 8;

__global__ void __launch_bounds__(kThreads)
freespace_components_kernel(const uint8_t* __restrict__ grid, int G,
                            const float* __restrict__ origin, float voxel,
                            int nc, int iters, float* __restrict__ centers,
                            uint8_t* __restrict__ valid,
                            int* __restrict__ top_sz,
                            int* __restrict__ top_lab,
                            int* __restrict__ labels_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = G * G * G, GG = G * G;
    const uint16_t BIG = (uint16_t)(N + 1);
    uint16_t* la = reinterpret_cast<uint16_t*>(smem);
    uint16_t* lb = la + N;
    const int tid = threadIdx.x;
    for (int v = tid; v < N; v += kThreads) la[v] = grid[v] ? v : BIG;
    __syncthreads();
    uint16_t* cur = la;
    uint16_t* nxt = lb;
    for (int it = 0; it < iters; ++it) {
        for (int v = tid; v < N; v += kThreads) {
            uint16_t l = cur[v];
            if (l != BIG) {
                const int i = v / GG, j = (v / G) % G, k = v % G;
                // the six neighbours, BIG past the faces (no wrap-around)
                if (i > 0) l = umin16(l, cur[v - GG]);
                if (i < G - 1) l = umin16(l, cur[v + GG]);
                if (j > 0) l = umin16(l, cur[v - G]);
                if (j < G - 1) l = umin16(l, cur[v + G]);
                if (k > 0) l = umin16(l, cur[v - 1]);
                if (k < G - 1) l = umin16(l, cur[v + 1]);
            }
            nxt[v] = l;
        }
        __syncthreads();
        uint16_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
    for (int v = tid; v < N; v += kThreads) {
        const uint16_t l = cur[v];
        if (labels_out != nullptr) labels_out[v] = l;
        if (cur != la) la[v] = l;
    }
    // the histogram takes the second label buffer and beyond
    int* hist = reinterpret_cast<int*>(smem + 2 * (size_t)N);
    __shared__ int red_sz[kThreads / 32], red_lab[kThreads / 32];
    __shared__ int sel_lab[kMaxClusters], sel_sz[kMaxClusters];
    __shared__ int sums[kMaxClusters][4];
    __syncthreads();
    for (int v = tid; v < N; v += kThreads) hist[v] = 0;
    if (tid < kMaxClusters * 4) sums[tid / 4][tid % 4] = 0;
    __syncthreads();
    for (int v = tid; v < N; v += kThreads) {
        if (la[v] != BIG) atomicAdd(&hist[la[v]], 1);
    }
    __syncthreads();
    // top-nc by size, the lower label first on ties; a taken label reads -1
    for (int c = 0; c < nc; ++c) {
        int bs = -2, bl = N;
        for (int v = tid; v < N; v += kThreads) {
            const int s = hist[v];
            if (s > bs || (s == bs && v < bl)) {
                bs = s;
                bl = v;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const int os = __shfl_xor_sync(0xffffffffu, bs, off);
            const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
            if (os > bs || (os == bs && ol < bl)) {
                bs = os;
                bl = ol;
            }
        }
        if ((tid & 31) == 0) {
            red_sz[tid >> 5] = bs;
            red_lab[tid >> 5] = bl;
        }
        __syncthreads();
        if (tid == 0) {
            for (int q = 1; q < kThreads / 32; ++q) {
                if (red_sz[q] > bs || (red_sz[q] == bs && red_lab[q] < bl)) {
                    bs = red_sz[q];
                    bl = red_lab[q];
                }
            }
            sel_sz[c] = bs;
            sel_lab[c] = bl;
            hist[bl] = -1;
        }
        __syncthreads();
    }
    // integer coordinate sums of each selected component (exact)
    int acc[kMaxClusters][4];
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[c][q] = 0;
    }
    for (int v = tid; v < N; v += kThreads) {
        const int l = la[v];
#pragma unroll
        for (int c = 0; c < kMaxClusters; ++c) {
            if (c < nc && l == sel_lab[c]) {
                acc[c][0] += v / GG;
                acc[c][1] += (v / G) % G;
                acc[c][2] += v % G;
                acc[c][3] += 1;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < kMaxClusters; ++c) {
        if (c >= nc) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int a = acc[c][q];
            for (int off = 16; off > 0; off >>= 1) {
                a += __shfl_xor_sync(0xffffffffu, a, off);
            }
            if ((tid & 31) == 0 && a != 0) atomicAdd(&sums[c][q], a);
        }
    }
    __syncthreads();
    if (tid < nc) {
        const int c = tid;
        const float cnt = (float)max(sums[c][3], 1);
        for (int q = 0; q < 3; ++q) {
            const float ctr = __fdiv_rn((float)sums[c][q], cnt);
            centers[3 * c + q] =
                __fmaf_rn(__fadd_rn(ctr, 0.5f), voxel, origin[q]);
        }
        top_sz[c] = sel_sz[c];
        top_lab[c] = sel_lab[c];
        valid[c] = sel_sz[c] > 8 ? 1 : 0;
    }
}

}  // namespace

// depth: (h, w) f32 metres; K: (4,) fx fy cx cy; R: (3, 3) row-major and
// C: (3,) of T_wc; origin: (3,) the grid's world min corner; grid:
// (G, G, G) bool, updated in place.
VSG_API int vsg_freespace_carve(const float* depth, int h, int w, int stride,
                                const float* K, const float* R,
                                const float* C, const float* origin,
                                float voxel, int G, uint8_t* grid,
                                cudaStream_t stream) {
    const int hs = (h + stride - 1) / stride, ws = (w + stride - 1) / stride;
    const int n = 5 * hs * ws;
    if (n == 0) return 0;
    const int threads = 256;
    freespace_carve_kernel<<<(n + threads - 1) / threads, threads, 0,
                             stream>>>(depth, h, w, stride, hs, ws, K, R, C,
                                       origin, voxel, G, grid);
    return (int)cudaGetLastError();
}

// grid: (G, G, G) bool, G <= 32; origin: (3,) f32.  Outputs: centers
// (nc, 3) f32, valid (nc,) bool, top_sz / top_lab (nc,) i32, labels
// (G, G, G) i32 (G^3 + 1 where not free; may be null); nc <= 8.
VSG_API int vsg_freespace_components(const uint8_t* grid, int G,
                                     const float* origin, float voxel,
                                     int nc, int iters, float* centers,
                                     uint8_t* valid, int* top_sz,
                                     int* top_lab, int* labels,
                                     cudaStream_t stream) {
    const int N = G * G * G;
    if (G < 1 || N + 1 > 65535 || nc < 1 || nc > kMaxClusters) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = 6 * (size_t)N;  // 2 x u16 labels, then u16 + i32
    cudaError_t e = cudaFuncSetAttribute(
        freespace_components_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    freespace_components_kernel<<<1, kThreads, smem, stream>>>(
        grid, G, origin, voxel, nc, iters, centers, valid, top_sz, top_lab,
        labels);
    return (int)cudaGetLastError();
}
