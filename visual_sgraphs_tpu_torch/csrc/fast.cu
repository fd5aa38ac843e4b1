// K2: FAST-9 corner score + 3x3 non-maximum suppression.
//
// Replaces visual_sgraphs_tpu/features/fast.py::fast_score and ::nms3x3
// (called per pyramid level from features/orb.py::extract_orb).  The JAX
// version stacks 16 edge-padded shifted copies of the level and reduces
// them; that is 16 image-sized intermediates of device traffic per level.
//
// What bounds it here: device-memory bytes.  Per pixel the arithmetic is
// ~300 min/max operations on values already on chip, so the kernel should
// touch each input pixel about once and write each output once.
//
// Design: pass 1 gives one thread per output pixel over a shared-memory
// tile with a 3-pixel halo, loaded with edge-clamped coordinates (the
// reference's jnp.pad(mode="edge")).  The 16 ring differences sit in
// registers; the 16 cyclic 9-arc minima are taken in both polarities.
// Pass 2 is the 3x3 NMS (-inf outside the image), a small stencil that
// reads pass 1's score from L2.  Subtraction, min and max are exact, so
// the result is bitwise equal to the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int HALO = 3;

__constant__ int kRingDr[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDc[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ score, int h, int w) {
    img += (size_t)blockIdx.z * h * w;
    score += (size_t)blockIdx.z * h * w;
    __shared__ float tile[TH + 2 * HALO][TW + 2 * HALO];
    const int r0 = blockIdx.y * TH - HALO;
    const int c0 = blockIdx.x * TW - HALO;
    const int tid = threadIdx.y * TW + threadIdx.x;
    for (int i = tid; i < (TH + 2 * HALO) * (TW + 2 * HALO); i += TW * TH) {
        const int tr = i / (TW + 2 * HALO);
        const int tc = i % (TW + 2 * HALO);
        const int rr = min(max(r0 + tr, 0), h - 1);
        const int cc = min(max(c0 + tc, 0), w - 1);
        tile[tr][tc] = img[rr * w + cc];
    }
    __syncthreads();
    const int r = blockIdx.y * TH + threadIdx.y;
    const int c = blockIdx.x * TW + threadIdx.x;
    if (r >= h || c >= w) return;
    const float p = tile[threadIdx.y + HALO][threadIdx.x + HALO];
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        d[i] = tile[threadIdx.y + HALO + kRingDr[i]]
                   [threadIdx.x + HALO + kRingDc[i]] - p;
    }
    float bright = -INFINITY;
    float dark = -INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        float mb = d[s];
        float md = -d[s];
#pragma unroll
        for (int k = 1; k < 9; ++k) {
            const float v = d[(s + k) & 15];
            mb = fminf(mb, v);
            md = fminf(md, -v);
        }
        bright = fmaxf(bright, mb);
        dark = fmaxf(dark, md);
    }
    float sc = fmaxf(fmaxf(bright, dark), 0.0f);
    const bool interior = r >= 3 && r < h - 3 && c >= 3 && c < w - 3;
    score[r * w + c] = interior ? sc : 0.0f;
}

__global__ void nms3x3_kernel(const float* __restrict__ score,
                              float* __restrict__ out, int h, int w) {
    score += (size_t)blockIdx.z * h * w;
    out += (size_t)blockIdx.z * h * w;
    const int r = blockIdx.y * blockDim.y + threadIdx.y;
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= h || c >= w) return;
    const float s = score[r * w + c];
    float m = -INFINITY;
    for (int dr = -1; dr <= 1; ++dr) {
        const int rr = r + dr;
        if (rr < 0 || rr >= h) continue;
        for (int dc = -1; dc <= 1; ++dc) {
            const int cc = c + dc;
            if (cc < 0 || cc >= w) continue;
            m = fmaxf(m, score[rr * w + cc]);
        }
    }
    out[r * w + c] = (s >= m) ? s : 0.0f;
}

}  // namespace

// img, score_tmp, out: (B, h, w) float32, contiguous, on the device (a
// batch of frames' levels of one size).
VSG_API int vsg_fast_nms(const float* img, float* score_tmp, float* out,
                         int B, int h, int w, cudaStream_t stream) {
    if (B == 0) return 0;
    dim3 block(TW, TH);
    dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
    fast_score_kernel<<<grid, block, 0, stream>>>(img, score_tmp, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms3x3_kernel<<<grid, block, 0, stream>>>(score_tmp, out, h, w);
    return (int)cudaGetLastError();
}

VSG_API const char* vsg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
