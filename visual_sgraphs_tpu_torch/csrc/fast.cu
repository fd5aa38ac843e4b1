// K2: FAST-9 corner score + 3x3 non-maximum suppression of every level
// of every frame of an ORB extraction, in one launch.
//
// Replaces visual_sgraphs_tpu/features/fast.py::fast_score and ::nms3x3
// (called per pyramid level from features/orb.py::extract_orb).  The JAX
// version stacks 16 edge-padded shifted copies of the level and reduces
// them; that is 16 image-sized intermediates of device traffic per level.
//
// What bounds it here: the min / max work.  The bytes (each level read
// once, each score written once: 60.8 MB for a batch of 8 480x640
// frames' 8 levels) take 0.018 ms at 3.35 TB/s; the ~116 min / max
// operations an output pixel run at half the card's FMA rate.
//
// Design:
// - the levels' descriptors (image and output pointers, and the plan of
//   features/fast.py::fast_tile_plan: h, w, tiles across, first tile) go
//   in a by-value kernel parameter, so a launch needs no host-to-device
//   copy; the grid is (every level's 32x32 output tiles, frames), and a
//   CTA finds its level from the first-tile offsets;
// - a CTA stages its tile with a 4-pixel halo (3 for the ring, 1 for the
//   NMS), edge-clamped coordinates (the reference's jnp.pad(mode="edge")),
//   every load in flight before the first shared store;
// - it scores the tile and a 1-pixel ring around it into shared memory:
//   0 within 3 pixels of the level's edge, -inf outside the level (the
//   NMS's padding);
// - the arc extrema avoid brute force.  Subtracting p is monotone, so
//   min_k fl(ring_k - p) = fl(min_k ring_k - p): the bright score is
//   fl(max_i min_{k in arc i} ring_k - p) and the dark one
//   fl(p - min_i max_{k in arc i} ring_k).  Neighbouring arcs 2k and
//   2k + 1 share 8 ring positions, whose extremum comes from pair, quad
//   and octet extrema: 47 operations a polarity for the 16 arcs and
//   their combination, instead of 143 (a van Herk / Gil-Werman form over
//   blocks of 9 took 57);
// - the NMS reads the score tile: a thread takes 4 rows of one column,
//   with the row maxima of 3 shared between them;
// - each output pixel is written once; no temporary image.
// A two-pass form that first listed the positions by the polarities their
// compass points leave (ring positions 0, 4, 8, 12), then scored each in
// those alone, ran 25 % slower on the card (measured): most positions of
// a rendered frame keep a polarity.
// Subtraction, min and max are exact, so the result is bitwise equal to
// the plain PyTorch version (by value: +0 and -0 are equal).
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int TW = 32;                // output tile (fast.py's TILE)
constexpr int TH = 32;
constexpr int SW = TW + 2;            // score tile: a 1-pixel NMS ring
constexpr int SH = TH + 2;
constexpr int IW = TW + 8;            // input tile: 3 ring + 1 NMS a side
constexpr int IH = TH + 8;
constexpr int THREADS = 256;
constexpr int ROWS = TH * TW / THREADS;  // NMS outputs a thread (a column)
constexpr int LOADS = (IH * IW + THREADS - 1) / THREADS;

struct FastLevel {
    const float* img;  // (B, h, w)
    float* out;        // (B, h, w)
    int h, w, tiles_x, tile0;
};

struct FastLevels {
    FastLevel lv[MAX_LEVELS];
    int n;
};

template <bool kMin>
__device__ __forceinline__ float ext(float a, float b) {
    return kMin ? fminf(a, b) : fmaxf(a, b);
}

// kMin: max over the 16 cyclic 9-arcs of the arc's minimum of v;
// otherwise min over the arcs of the arc's maximum.  Arcs 2k and 2k + 1
// share the octet o = v[2k+1..2k+8], so the better of the two is
// ext(o, comb(v[2k], v[2k+9])); the octets come from pair, quad and octet
// extrema at the odd positions: 24 + 16 + 7 operations a polarity.
template <bool kMin>
__device__ __forceinline__ float arc_extreme(const float (&v)[16]) {
    float pair[8], quad[8], oct[8];  // v[2k+1..2k+2], ..2k+4], ..2k+8]
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        pair[k] = ext<kMin>(v[2 * k + 1], v[(2 * k + 2) & 15]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        quad[k] = ext<kMin>(pair[k], pair[(k + 1) & 7]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) oct[k] = ext<kMin>(quad[k], quad[(k + 2) & 7]);
    float best = ext<kMin>(oct[0], ext<!kMin>(v[0], v[9]));
#pragma unroll
    for (int k = 1; k < 8; ++k) {
        best = ext<!kMin>(best, ext<kMin>(oct[k], ext<!kMin>(
                                              v[2 * k], v[(2 * k + 9) & 15])));
    }
    return best;
}

// FAST-9 score of the pixel at (r, c) of the input tile (>= 3 from its
// edge), before the clamp at 0
__device__ __forceinline__ float fast_score(const float (*in)[IW], int r,
                                            int c) {
    // Bresenham circle of radius 3, OpenCV ordering
    constexpr int dr[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                            3, 3, 2, 1, 0, -1, -2, -3};
    constexpr int dc[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = in[r + dr[i]][c + dc[i]];
    const float p = in[r][c];
    const float bright = __fsub_rn(arc_extreme<true>(v), p);
    const float dark = __fsub_rn(p, arc_extreme<false>(v));
    return fmaxf(bright, dark);
}

__global__ void __launch_bounds__(THREADS)
fast_levels_kernel(const FastLevels L) {
    __shared__ float in[IH][IW];
    __shared__ float sc[SH][SW];
    int l = 0;
#pragma unroll
    for (int i = 1; i < MAX_LEVELS; ++i) {
        if (i < L.n && (int)blockIdx.x >= L.lv[i].tile0) l = i;
    }
    const FastLevel lv = L.lv[l];
    const int h = lv.h, w = lv.w;
    const int tile = blockIdx.x - lv.tile0;
    const int ty = tile / lv.tiles_x;
    const int r0 = ty * TH, c0 = (tile - ty * lv.tiles_x) * TW;
    const size_t frame = (size_t)blockIdx.y * h * w;
    const float* img = lv.img + frame;
    const int tid = threadIdx.x;

    float v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
        const int i = min(tid + k * THREADS, IH * IW - 1);
        const int rr = min(max(r0 - 4 + i / IW, 0), h - 1);
        const int cc = min(max(c0 - 4 + i % IW, 0), w - 1);
        v[k] = __ldg(img + (size_t)rr * w + cc);
    }
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
        const int i = tid + k * THREADS;
        if (i < IH * IW) in[i / IW][i % IW] = v[k];
    }
    __syncthreads();

    for (int i = tid; i < SH * SW; i += THREADS) {
        const int sr = i / SW, scc = i % SW;
        const int r = r0 - 1 + sr, c = c0 - 1 + scc;
        float s;
        if (r < 0 || r >= h || c < 0 || c >= w) {
            s = -INFINITY;
        } else if (r < 3 || r >= h - 3 || c < 3 || c >= w - 3) {
            s = 0.0f;
        } else {
            s = fmaxf(fast_score(in, sr + 3, scc + 3), 0.0f);
        }
        sc[sr][scc] = s;
    }
    __syncthreads();

    // a thread: column x of the tile, rows y0..y0+ROWS-1
    const int x = tid % TW;
    const int y0 = (tid / TW) * ROWS;
    float hmax[ROWS + 2];
#pragma unroll
    for (int k = 0; k < ROWS + 2; ++k) {
        hmax[k] = fmaxf(fmaxf(sc[y0 + k][x], sc[y0 + k][x + 1]),
                        sc[y0 + k][x + 2]);
    }
    float* out = lv.out + frame;
    const int c = c0 + x;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int r = r0 + y0 + k;
        if (r < h && c < w) {
            const float s = sc[y0 + k + 1][x + 1];
            const float m = fmaxf(fmaxf(hmax[k], hmax[k + 1]), hmax[k + 2]);
            out[(size_t)r * w + c] = s >= m ? s : 0.0f;
        }
    }
}

}  // namespace

// imgs, outs: n_levels pointers to (B, h, w) float32 levels and their
// score images, contiguous, on the device; plan: (h, w, tiles across,
// first tile) per level, n_tiles the tiles a frame
// (features/fast.py::fast_tile_plan).
VSG_API int vsg_fast_levels(const float* const* imgs, float* const* outs,
                            const int* plan, int n_levels, int n_tiles,
                            int B, cudaStream_t stream) {
    if (B == 0 || n_levels == 0) return 0;
    if (n_levels > MAX_LEVELS || B > 65535 || n_tiles < 1) {
        return (int)cudaErrorInvalidValue;
    }
    FastLevels L = {};
    L.n = n_levels;
    for (int l = 0; l < n_levels; ++l) {
        const int* p = plan + 4 * l;
        if (p[0] < 1 || p[1] < 1) return (int)cudaErrorInvalidValue;
        L.lv[l] = FastLevel{imgs[l], outs[l], p[0], p[1], p[2], p[3]};
    }
    fast_levels_kernel<<<dim3(n_tiles, B), THREADS, 0, stream>>>(L);
    return (int)cudaGetLastError();
}

VSG_API const char* vsg_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
