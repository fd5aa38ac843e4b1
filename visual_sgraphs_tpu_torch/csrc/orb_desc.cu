// K4: intensity-centroid angle + steered BRIEF-256, one warp per keypoint.
//
// Replaces visual_sgraphs_tpu/features/orb.py::_gather_patches,
// ::_ic_angle and ::_steered_brief.  The JAX version materialises a
// (K, 41, 41) patch tensor per level in device memory and reduces it with
// masked sums and take_along_axis gathers.
//
// What bounds it here: latency of scattered reads and of the moment sums.
// Each keypoint needs a 41x41 window of one level image (6.7 KB, mostly
// L2 hits) and ~1400 multiply-adds; at 1000 keypoints per frame the data
// is a few MB against ~3 MFLOP.
//
// Design: one warp per keypoint stages its 41x41 patch in shared memory
// (the patch tensor never exists in device memory): origin clipped to
// [0, max(h,41)-41], reads past a level smaller than the patch clamped to
// the last row/column, which is the reference's edge pad.  Lanes 0 and 1
// then sum m10 and m01 over the r=15 disc in row-major order with
// __fmul_rn/__fadd_rn, the order and rounding of the plain PyTorch version
// (and of XLA's CPU reduction), so the angle is reproducible bitwise; the
// ~700-term serial sums cost a few microseconds of latency per warp, hidden
// by ~1000 warps in flight.  Lane b evaluates tests 8b..8b+7 and writes
// byte b (bit j = test 8b+j, as the reference packs them).  The rotation
// uses __fmul_rn/__fadd_rn (no contracted multiply-add) and rintf (half to
// even, like torch.round), so given the same angle the descriptor is
// bitwise equal to the plain version.
#include "common.cuh"

namespace {

constexpr int PATCH_R = 15;
constexpr int GATHER_R = 20;
constexpr int SIZE = 2 * GATHER_R + 1;
constexpr int WARPS = 4;

__device__ __forceinline__ int sample_index(float v) {
    const float f = rintf(v) + (float)GATHER_R;
    return (int)fminf(fmaxf(f, 0.0f), (float)(2 * GATHER_R));
}

__global__ void __launch_bounds__(32 * WARPS)
orb_desc_kernel(const float* __restrict__ img, int h, int w,
                const int* __restrict__ rc, int n_kp, int stride,
                const float* __restrict__ pattern,
                const float* __restrict__ angle_in,
                float* __restrict__ angle_out, uint8_t* __restrict__ desc) {
    __shared__ float patch[WARPS][SIZE * SIZE];
    // blockIdx.y: the frame of a batch (one level of each frame)
    img += (size_t)blockIdx.y * h * w;
    rc += (size_t)blockIdx.y * stride * 2;
    if (angle_in != nullptr) angle_in += (size_t)blockIdx.y * stride;
    angle_out += (size_t)blockIdx.y * stride;
    desc += (size_t)blockIdx.y * stride * 32;
    const int wib = threadIdx.x >> 5;
    const int kp = blockIdx.x * WARPS + wib;
    const int lane = threadIdx.x & 31;
    if (kp >= n_kp) return;  // the whole warp leaves; no block barrier below
    float* P = patch[wib];
    const int hp = max(h, SIZE);
    const int wp = max(w, SIZE);
    const int r0 = min(max(rc[2 * kp] - GATHER_R, 0), hp - SIZE);
    const int c0 = min(max(rc[2 * kp + 1] - GATHER_R, 0), wp - SIZE);
    for (int i = lane; i < SIZE * SIZE; i += 32) {
        const int rr = min(r0 + i / SIZE, h - 1);
        const int cc = min(c0 + i % SIZE, w - 1);
        P[i] = img[rr * w + cc];
    }
    __syncwarp();

    float ang;
    if (angle_in != nullptr) {
        ang = angle_in[kp];
    } else {
        // lane 0: m10 = sum v*x, lane 1: m01 = sum v*y, row-major over the
        // disc; zero-weight terms add +0 and are skipped
        float m = 0.0f;
        if (lane < 2) {
            const int d = GATHER_R - PATCH_R;
            for (int y = -PATCH_R; y <= PATCH_R; ++y) {
                for (int x = -PATCH_R; x <= PATCH_R; ++x) {
                    const int wgt = lane == 0 ? x : y;
                    if (wgt == 0 || x * x + y * y > PATCH_R * PATCH_R) {
                        continue;
                    }
                    const float v = P[(d + PATCH_R + y) * SIZE +
                                      (d + PATCH_R + x)];
                    m = __fadd_rn(m, __fmul_rn(v, (float)wgt));
                }
            }
        }
        const float m10 = __shfl_sync(0xffffffffu, m, 0);
        const float m01 = __shfl_sync(0xffffffffu, m, 1);
        ang = atan2f(m01, m10);
    }
    if (lane == 0) angle_out[kp] = ang;

    const float ca = cosf(ang);
    const float sa = sinf(ang);
    unsigned int byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float* pt = pattern + 4 * (8 * lane + j);
        const float x1 = __fsub_rn(__fmul_rn(ca, pt[0]), __fmul_rn(sa, pt[1]));
        const float y1 = __fadd_rn(__fmul_rn(sa, pt[0]), __fmul_rn(ca, pt[1]));
        const float x2 = __fsub_rn(__fmul_rn(ca, pt[2]), __fmul_rn(sa, pt[3]));
        const float y2 = __fadd_rn(__fmul_rn(sa, pt[2]), __fmul_rn(ca, pt[3]));
        const float v1 = P[sample_index(y1) * SIZE + sample_index(x1)];
        const float v2 = P[sample_index(y2) * SIZE + sample_index(x2)];
        byte |= (v1 < v2 ? 1u : 0u) << j;
    }
    desc[32 * kp + lane] = (uint8_t)byte;
}

}  // namespace

// img: (B, h, w) f32 blurred level of B frames; rc: (B, n_kp, 2) i32
// (row, col); pattern: (256, 4) f32 (x1, y1, x2, y2); angle_in: (B, n_kp)
// f32 or NULL (then the IC angle is computed); angle_out: (B, n_kp) f32;
// desc: (B, n_kp, 32) u8; the frames of rc, angle_in, angle_out and desc
// are `stride` keypoints apart (a level's rows of an extraction's arrays).
VSG_API int vsg_orb_desc(const float* img, int B, int h, int w,
                         const int* rc, int n_kp, int stride,
                         const float* pattern,
                         const float* angle_in, float* angle_out,
                         uint8_t* desc, cudaStream_t stream) {
    if (n_kp == 0 || B == 0) return 0;
    const int blocks = (n_kp + WARPS - 1) / WARPS;
    orb_desc_kernel<<<dim3(blocks, B), 32 * WARPS, 0, stream>>>(
        img, h, w, rc, n_kp, stride, pattern, angle_in, angle_out, desc);
    return (int)cudaGetLastError();
}
