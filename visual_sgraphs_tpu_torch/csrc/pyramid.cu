// K1: the ORB image pyramid for a batch of frames: the 7-tap Gaussian blur
// and the antialiased bilinear downscale.
//
// Replaces visual_sgraphs_tpu/features/pyramid.py:27 gaussian_blur (sigma 2,
// edge replication, vertical pass then horizontal) and :43 resize_bilinear
// (jax.image.resize's "bilinear" with antialiasing: each output sample is a
// normalised triangle-kernel average whose support widens by the inverse
// scale; rows first, then columns), which :56 build_pyramid chains into 8
// levels of 1/1.2.  The reference resizes with dense (n_in, n_out) weight
// matrices; the plain twin applies the same weights as a band.
//
// What bounds it here: memory bytes.  A 480x640 frame's pyramid reads and
// writes ~3.4 MB per pass; per pixel the work is 3-4 (resize) or 14 (blur)
// multiply-adds.
//
// Design: the resize's band (first source index and up to T float32
// weights per output, T = 3 at 1/1.2) is computed once per (n_in, n_out)
// on the host from the same float64-derived float32 weights as the twin's,
// and passed in; one kernel applies the vertical band into a scratch image
// and a second the horizontal band, one thread per output sample.  Each
// output accumulates its taps in order with one fused multiply-add per tap
// (__fmaf_rn, from 0), the rounding of a matrix product's dot over the
// dense weights (the zero weights add nothing); the twin emulates the
// fused step in float64.  The blur loads a (TH + 6) x (TW + 6) tile with
// clamped coordinates into shared memory, runs the vertical taps into a
// second tile and the horizontal taps out of it, each product and sum
// written with __fmul_rn / __fadd_rn in the twin's order (nvcc would
// contract a * b + c into an FMA).  Both are bitwise equal to the twin on
// the card but for a rare double rounding in the twin's emulation.
#include "common.cuh"

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int HALF = 3;
constexpr int TAPS = 2 * HALF + 1;

__global__ void blur_kernel(const float* __restrict__ img,
                            const float* __restrict__ taps,
                            float* __restrict__ out, int h, int w) {
    __shared__ float tin[TH + 2 * HALF][TW + 2 * HALF];
    __shared__ float tmid[TH][TW + 2 * HALF];
    const int b = blockIdx.z;
    const float* src = img + (size_t)b * h * w;
    float* dst = out + (size_t)b * h * w;
    const int r0 = blockIdx.y * TH - HALF;
    const int c0 = blockIdx.x * TW - HALF;
    const int tid = threadIdx.y * TW + threadIdx.x;
    float k[TAPS];
#pragma unroll
    for (int i = 0; i < TAPS; ++i) k[i] = taps[i];
    for (int i = tid; i < (TH + 2 * HALF) * (TW + 2 * HALF); i += TW * TH) {
        const int tr = i / (TW + 2 * HALF);
        const int tc = i % (TW + 2 * HALF);
        const int rr = min(max(r0 + tr, 0), h - 1);
        const int cc = min(max(c0 + tc, 0), w - 1);
        tin[tr][tc] = src[(size_t)rr * w + cc];
    }
    __syncthreads();
    for (int i = tid; i < TH * (TW + 2 * HALF); i += TW * TH) {
        const int tr = i / (TW + 2 * HALF);
        const int tc = i % (TW + 2 * HALF);
        float acc = __fmul_rn(k[0], tin[tr][tc]);
#pragma unroll
        for (int t = 1; t < TAPS; ++t) {
            acc = __fadd_rn(acc, __fmul_rn(k[t], tin[tr + t][tc]));
        }
        tmid[tr][tc] = acc;
    }
    __syncthreads();
    const int r = blockIdx.y * TH + threadIdx.y;
    const int c = blockIdx.x * TW + threadIdx.x;
    if (r >= h || c >= w) return;
    float acc = __fmul_rn(k[0], tmid[threadIdx.y][threadIdx.x]);
#pragma unroll
    for (int t = 1; t < TAPS; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(k[t], tmid[threadIdx.y][threadIdx.x + t]));
    }
    dst[(size_t)r * w + c] = acc;
}

// out[b, o, c] = sum_t wt[o, t] * in[b, min(first[o] + t, h - 1), c]
__global__ void resize_rows_kernel(const float* __restrict__ in, int h,
                                   int w, int ho,
                                   const int* __restrict__ first,
                                   const float* __restrict__ wt, int T,
                                   float* __restrict__ out) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int o = blockIdx.y;
    const int b = blockIdx.z;
    if (c >= w) return;
    const float* src = in + (size_t)b * h * w;
    const int f = first[o];
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
        acc = __fmaf_rn(wt[o * T + t], src[(size_t)min(f + t, h - 1) * w + c],
                        acc);
    }
    out[((size_t)b * ho + o) * w + c] = acc;
}

// out[b, r, o] = sum_t wt[o, t] * in[b, r, min(first[o] + t, w - 1)]
__global__ void resize_cols_kernel(const float* __restrict__ in, int h,
                                   int w, int wo,
                                   const int* __restrict__ first,
                                   const float* __restrict__ wt, int T,
                                   float* __restrict__ out) {
    const int o = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y;
    const int b = blockIdx.z;
    if (o >= wo) return;
    const float* src = in + ((size_t)b * h + r) * w;
    const int f = first[o];
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
        acc = __fmaf_rn(wt[o * T + t], src[min(f + t, w - 1)], acc);
    }
    out[((size_t)b * h + r) * wo + o] = acc;
}

}  // namespace

// img, out: (B, h, w) f32; taps: (7,) f32.
VSG_API int vsg_blur(const float* img, const float* taps, float* out, int B,
                     int h, int w, cudaStream_t stream) {
    if (B == 0) return 0;
    dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
    blur_kernel<<<grid, dim3(TW, TH), 0, stream>>>(img, taps, out, h, w);
    return (int)cudaGetLastError();
}

// img: (B, h, w) f32 -> out: (B, ho, wo) f32.  A pass whose size does not
// change is skipped (rows_first == NULL or cols_first == NULL); with both
// passes, tmp: (B, ho, w) f32 holds the rows' result.
VSG_API int vsg_resize(const float* img, float* tmp, float* out, int B,
                       int h, int w, int ho, int wo, const int* rows_first,
                       const float* rows_wt, int rows_T,
                       const int* cols_first, const float* cols_wt,
                       int cols_T, cudaStream_t stream) {
    if (B == 0) return 0;
    const float* src = img;
    int hh = h;
    if (rows_first != nullptr) {
        float* dst = cols_first != nullptr ? tmp : out;
        resize_rows_kernel<<<dim3((w + 127) / 128, ho, B), 128, 0, stream>>>(
            img, h, w, ho, rows_first, rows_wt, rows_T, dst);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        src = dst;
        hh = ho;
    }
    if (cols_first != nullptr) {
        resize_cols_kernel<<<dim3((wo + 127) / 128, hh, B), 128, 0,
                             stream>>>(src, hh, w, wo, cols_first, cols_wt,
                                       cols_T, out);
    }
    return (int)cudaGetLastError();
}
