// K4: intensity-centroid angle + steered BRIEF-256 of every keypoint of
// every level and frame of an ORB extraction, in one launch.
//
// Replaces visual_sgraphs_tpu/features/orb.py::_gather_patches,
// ::_ic_angle and ::_steered_brief (called per pyramid level from
// extract_orb).  The JAX version materialises a (K, 41, 41) patch tensor
// per level in device memory and reduces it with masked sums and
// take_along_axis gathers.
//
// What bounds it here: latency.  Each keypoint needs a 41x41 window of
// one blurred level (6.7 KB, mostly L2 hits), two moments of 678 terms
// each, summed in a fixed order, and 256 rotated pair tests.
//
// Design:
// - the levels' descriptors (blurred image, h, w, first row) go in a
//   by-value kernel parameter; the grid is (runs of KP keypoint rows,
//   frames), and a row finds its level from the first-row offsets;
// - a CTA stages its KP patches in shared memory with cp.async, every
//   copy in flight at once (the patch tensor never exists in device
//   memory): origin clipped to [0, max(h, 41) - 41], reads past a level
//   smaller than the patch clamped to its last row / column, which is the
//   reference's edge pad;
// - the moments: lane k of warp 0 sums m10 of keypoint k and lane k of
//   warp 1 its m01 (the two on different schedulers), each over its
//   moment's non-zero-weight disc positions in row-major order
//   (disc_run, checked at compile time: the rows of the disc as
//   runs of equal half width, what the twin's _ic_terms holds) with
//   __fmul_rn / __fadd_rn: the order and rounding of the plain PyTorch
//   version and of XLA's CPU reduction, so the angle reproduces bitwise.
//   A term is a load with a constant offset, a multiply and an add: a
//   table of the terms' positions (in constant memory or through L1)
//   waited ~40 cycles a term on the table, and a per-row bit mask of the
//   terms ~11 cycles a position of the 31x31 square on its tests
//   (measured);
// - BRIEF: a warp a keypoint; lane b evaluates tests b, b + 32, ...,
//   b + 224 (the pattern read as float4, lanes on consecutive rows), and
//   a ballot of test 32j + b over the warp is descriptor bytes 4j..4j+3,
//   little-endian, so lanes 0-7 write the 32 bytes as 8 words.  The
//   rotation uses __fmul_rn / __fadd_rn (no contracted multiply-add) and
//   rintf (half to even, like torch.round), so given the same angle the
//   descriptor is bitwise equal to the plain version.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int PATCH_R = 15;
constexpr int GATHER_R = 20;
constexpr int SIZE = 2 * GATHER_R + 1;  // 41
constexpr int AREA = SIZE * SIZE;       // 1681 (odd: lanes on distinct banks)
constexpr int KP = 8;                   // keypoints a CTA
constexpr int THREADS = 32 * KP;        // a warp a keypoint for BRIEF
constexpr int N_TERMS = 678;            // non-zero x (or y) weights, r = 15

struct DescLevel {
    const float* img;  // (B, h, w) blurred
    int h, w, row0;
};

struct DescLevels {
    DescLevel lv[MAX_LEVELS];
    int n;
};

// The moments' terms, row by row: row dy of the r = 15 disc holds the
// positions |x| <= half_width(dy).  m10's terms are its positions with
// x != 0, m01's every position of the rows with dy != 0, each in
// row-major order (what the twin's _ic_terms holds).  Rows of equal half
// width come in runs; each run is one loop over its rows around straight
// code for one row (disc_run, checked against the disc at compile time), so
// a term is a shared load, a multiply and an add, with no test.
constexpr int half_width(int dy) {
    int x = 0;
    while ((x + 1) * (x + 1) + dy * dy <= PATCH_R * PATCH_R) ++x;
    return x;
}

struct Run {
    int hw, dy0, dy1;
};

constexpr int N_RUNS = 19;

// run g of the disc's rows (half width, first and last dy)
__host__ __device__ constexpr Run disc_run(int g) {
    constexpr Run runs[N_RUNS] = {
        {0, -15, -15}, {5, -14, -14}, {7, -13, -13}, {9, -12, -12},
        {10, -11, -11}, {11, -10, -10}, {12, -9, -8}, {13, -7, -6},
        {14, -5, -1}, {15, 0, 0}, {14, 1, 5}, {13, 6, 7}, {12, 8, 9},
        {11, 10, 10}, {10, 11, 11}, {9, 12, 12}, {7, 13, 13},
        {5, 14, 14}, {0, 15, 15}};
    return runs[g];
}

constexpr bool runs_cover_disc() {
    int next = -PATCH_R, n = 0;
    for (int g = 0; g < N_RUNS; ++g) {
        const Run r = disc_run(g);
        if (r.dy0 != next || r.dy1 < r.dy0) return false;
        for (int dy = r.dy0; dy <= r.dy1; ++dy) {
            if (half_width(dy) != r.hw) return false;
            n += 2 * r.hw;  // the row's terms with x != 0
        }
        next = r.dy1 + 1;
    }
    return next == PATCH_R + 1 && n == N_TERMS;
}

static_assert(runs_cover_disc(), "disc_run is the r = 15 disc, 678 terms");

// m += the terms of one row (row: the row's x = 0 position) of m10 (kX:
// weight x, x != 0) or m01 (weight dy)
template <int HW, bool kX>
__device__ __forceinline__ float row_terms(float m, const float* row,
                                           float dy) {
#pragma unroll
    for (int x = -HW; x <= HW; ++x) {
        if (kX && x == 0) continue;
        m = __fadd_rn(m, __fmul_rn(row[x], kX ? (float)x : dy));
    }
    return m;
}

// m10 (kX) or m01 of the patch whose centre is c, runs G.. of disc_run
template <bool kX, int G = 0>
__device__ __forceinline__ float disc_moment(const float* c, float m = 0.0f) {
    if constexpr (G == N_RUNS) {
        return m;
    } else {
        constexpr Run r = disc_run(G);
#pragma unroll 1
        for (int dy = r.dy0; dy <= r.dy1; ++dy) {
            if (kX || dy != 0) {
                m = row_terms<r.hw, kX>(m, c + dy * SIZE, (float)dy);
            }
        }
        return disc_moment<kX, G + 1>(c, m);
    }
}

__device__ __forceinline__ int sample_index(float v) {
    const float f = rintf(v) + (float)GATHER_R;
    return (int)fminf(fmaxf(f, 0.0f), (float)(2 * GATHER_R));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__global__ void __launch_bounds__(THREADS)
orb_desc_kernel(const DescLevels L, const int* __restrict__ rc, int n_kp,
                int stride, const float4* __restrict__ pattern,
                const float* __restrict__ angle_in,
                float* __restrict__ angle_out, uint32_t* __restrict__ desc) {
    extern __shared__ float patch[];  // [KP][AREA]
    __shared__ float mom[2][KP];
    const int first = blockIdx.x * KP;
    const int n_here = min(KP, n_kp - first);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t row = (size_t)blockIdx.y * stride + first + warp;

    // stage: warp k copies patch k, a row of 41 floats a pass
    if (warp < n_here) {
        int l = 0;
#pragma unroll
        for (int i = 1; i < MAX_LEVELS; ++i) {
            if (i < L.n && first + warp >= L.lv[i].row0) l = i;
        }
        const DescLevel lv = L.lv[l];
        const int h = lv.h, w = lv.w;
        const float* img = lv.img + (size_t)blockIdx.y * h * w;
        const int r0 = min(max(rc[2 * row] - GATHER_R, 0),
                           max(h, SIZE) - SIZE);
        const int c0 = min(max(rc[2 * row + 1] - GATHER_R, 0),
                           max(w, SIZE) - SIZE);
        float* P = patch + warp * AREA;
        const int c_a = min(c0 + lane, w - 1);
        const int c_b = min(c0 + 32 + lane, w - 1);
        for (int y = 0; y < SIZE; ++y) {
            const float* src = img + (size_t)min(r0 + y, h - 1) * w;
            cp_async4(P + y * SIZE + lane, src + c_a);
            if (lane < SIZE - 32) {
                cp_async4(P + y * SIZE + 32 + lane, src + c_b);
            }
        }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                     : "memory");
    __syncthreads();

    // the moments: warp a sums moment a (0: m10, 1: m01), lane k of
    // keypoint k, every lane of a warp on the same term
    if (angle_in == nullptr && warp < 2 && lane < KP) {
        const float* c = patch + lane * AREA + GATHER_R * (SIZE + 1);
        const float m =
            warp == 0 ? disc_moment<true>(c) : disc_moment<false>(c);
        mom[warp][lane] = m;
    }
    __syncthreads();
    if (warp >= n_here) return;

    const float ang = angle_in != nullptr ? angle_in[row]
                                          : atan2f(mom[1][warp], mom[0][warp]);
    if (lane == 0) angle_out[row] = ang;
    const float ca = cosf(ang);
    const float sa = sinf(ang);
    const float* P = patch + warp * AREA;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float4 pt = __ldg(pattern + 32 * j + lane);
        const float x1 = __fsub_rn(__fmul_rn(ca, pt.x), __fmul_rn(sa, pt.y));
        const float y1 = __fadd_rn(__fmul_rn(sa, pt.x), __fmul_rn(ca, pt.y));
        const float x2 = __fsub_rn(__fmul_rn(ca, pt.z), __fmul_rn(sa, pt.w));
        const float y2 = __fadd_rn(__fmul_rn(sa, pt.z), __fmul_rn(ca, pt.w));
        const float v1 = P[sample_index(y1) * SIZE + sample_index(x1)];
        const float v2 = P[sample_index(y2) * SIZE + sample_index(x2)];
        const uint32_t bits = __ballot_sync(0xffffffffu, v1 < v2);
        if (lane == j) word = bits;
    }
    if (lane < 8) desc[8 * row + lane] = word;
}

}  // namespace

// imgs: n_levels pointers to (B, h, w) f32 blurred levels; dims: (h, w,
// first row) per level (its rows of the extraction's keypoints run to the
// next level's first row); rc: (B, ., 2) i32 (row, col); the frames of
// rc, angle_in, angle_out and desc are `stride` keypoints apart, and rows
// 0..n_kp-1 of each frame are described; pattern: (256, 4) f32 (x1, y1,
// x2, y2), 16-byte aligned; angle_in: (B, .) f32 or NULL (then the IC
// angle is computed); angle_out: (B, .) f32; desc: (B, ., 32) u8, 4-byte
// aligned.
VSG_API int vsg_orb_desc_levels(const float* const* imgs, const int* dims,
                                int n_levels, int B, const int* rc,
                                int n_kp, int stride, const float* pattern,
                                const float* angle_in, float* angle_out,
                                uint8_t* desc, cudaStream_t stream) {
    if (n_kp == 0 || B == 0) return 0;
    if (n_levels < 1 || n_levels > MAX_LEVELS || B > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    DescLevels L = {};
    L.n = n_levels;
    for (int l = 0; l < n_levels; ++l) {
        const int* d = dims + 3 * l;
        if (d[0] < 1 || d[1] < 1) return (int)cudaErrorInvalidValue;
        L.lv[l] = DescLevel{imgs[l], d[0], d[1], d[2]};
    }
    constexpr size_t smem = (size_t)KP * AREA * sizeof(float);
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            orb_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    orb_desc_kernel<<<dim3((n_kp + KP - 1) / KP, B), THREADS, smem, stream>>>(
        L, rc, n_kp, stride, reinterpret_cast<const float4*>(pattern),
        angle_in, angle_out, reinterpret_cast<uint32_t*>(desc));
    return (int)cudaGetLastError();
}
