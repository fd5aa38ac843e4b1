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
// multiply-adds.  The resize chain of a batch of 8 moves ~50 MB, 0.015 ms
// at the card's rate, where 7 resizes of two launches each and their
// scratch images cost far more in launches and host time; the blur of the
// batch's 8 levels moves 60.8 MB, 0.018 ms.
//
// Design of the resize chain: the resize's bands (first source index and
// up to T float32 weights per output, T = 3 at 1/1.2) of every level, rows
// and columns, are computed once per (h, w, levels, scale) on the host
// from the same float64-derived float32 weights as the twin's and packed
// into one device table.  One launch builds levels 1..n of the batch into
// one buffer: a thread-block cluster a frame, a cluster barrier between
// levels, each tile's rows pass kept in shared memory (no scratch image).
// Each output accumulates its taps in order, the first a product and each
// next one fused multiply-add (__fmaf_rn), the rounding of a matrix
// product's dot over the dense weights (the zero weights add nothing);
// the twin emulates the fused step in float64.  Bitwise equal to the twin
// on the card but for a rare double rounding in the twin's emulation.
//
// Design of the blur (vsg_blur_levels): one launch for every level and
// frame of an extraction.  The levels' descriptors (image and output
// pointers, and the plan of features/pyramid.py::blur_tile_plan: h, w,
// tiles across, first tile) and the 7 taps go in a by-value kernel
// parameter, so a launch needs no host-to-device copy; the grid is (every
// level's output tiles, frames) and a CTA finds its level from the
// first-tile offsets, as K2 does.  A CTA of 256 threads blurs a 32 x 64
// output tile from a 38 x 70 staged window (each input read ~1.3 times,
// against ~2.1 with the 8 x 32 tiles of one launch a level before): every
// load of the window in flight before the first shared store, coordinates
// clamped to the level's own edges (edge replication, any level size,
// also under 7 pixels a side); the vertical taps run into a second shared
// tile, a thread a column and 8 rows from 14 loaded inputs, the
// horizontal taps out of it, a thread a row and 8 columns, into a third
// (the window's, now free), which the CTA writes out row by row,
// coalesced.  The window is staged and written a warp a row, so that a
// coordinate is clamped once a row and once a column, not divided and
// clamped at every load: per CTA the index work had been about as many
// instructions as the taps' sums.  Each product and sum is written with
// __fmul_rn / __fadd_rn in the twin's order (nvcc would contract a * b +
// c into an FMA), so the blur is bitwise equal to the twin.
#include "common.cuh"

namespace {

constexpr int HALF = 3;
constexpr int TAPS = 2 * HALF + 1;
constexpr int BLUR_MAX_LEVELS = 8;   // pyramid.py::BLUR_MAX_LEVELS
constexpr int BLUR_THREADS = 256;
constexpr int BT_R = 32;             // output tile (pyramid.py::BLUR_TILE)
constexpr int BT_C = 64;
constexpr int BW_R = BT_R + 2 * HALF;  // staged window
constexpr int BW_C = BT_C + 2 * HALF;
constexpr int BW_S = BW_C + 1;       // odd row strides: no bank conflicts
constexpr int BO_S = BT_C + 1;
constexpr int WARPS_B = BLUR_THREADS / 32;
constexpr int WIN_ROWS = (BW_R + WARPS_B - 1) / WARPS_B;  // a warp's rows
constexpr int WIN_COLS = (BW_C + 31) / 32;  // a lane's columns
constexpr int RUN = 8;               // outputs a thread in each pass
static_assert(BT_R * BT_C == RUN * BLUR_THREADS, "a thread 8 outputs");
static_assert(BT_R * BO_S <= BW_R * BW_S, "the output tile fits");

struct BlurLevel {
    const float* img;  // (B, h, w)
    float* out;        // (B, h, w)
    int h, w, tiles_x, tile0;
};

struct BlurLevels {
    BlurLevel lv[BLUR_MAX_LEVELS];
    float taps[TAPS];
    int n;
};

// RUN outputs of the 7-tap sum over x[0 .. RUN + 5], the taps in order
__device__ __forceinline__ void blur_run(const float (&x)[RUN + 2 * HALF],
                                         const float* k, float (&y)[RUN]) {
#pragma unroll
    for (int o = 0; o < RUN; ++o) {
        float acc = __fmul_rn(k[0], x[o]);
#pragma unroll
        for (int t = 1; t < TAPS; ++t) {
            acc = __fadd_rn(acc, __fmul_rn(k[t], x[o + t]));
        }
        y[o] = acc;
    }
}

__global__ void __launch_bounds__(BLUR_THREADS)
blur_levels_kernel(const BlurLevels L) {
    __shared__ float win[BW_R * BW_S];  // the window, then the output tile
    __shared__ float mid[BT_R * BW_S];  // the vertical pass
    int l = 0;
#pragma unroll
    for (int i = 1; i < BLUR_MAX_LEVELS; ++i) {
        if (i < L.n && (int)blockIdx.x >= L.lv[i].tile0) l = i;
    }
    const BlurLevel lv = L.lv[l];
    const int h = lv.h, w = lv.w;
    const int tile = blockIdx.x - lv.tile0;
    const int ty = tile / lv.tiles_x;
    const int r0 = ty * BT_R, c0 = (tile - ty * lv.tiles_x) * BT_C;
    const size_t frame = (size_t)blockIdx.y * h * w;
    const float* src = lv.img + frame;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float k[TAPS];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) k[t] = L.taps[t];

    // the window: a warp a row (rows warp, warp + 8, ...), a lane columns
    // lane, lane + 32 and lane + 64 (the last 6), each coordinate clamped
    // once; every load in flight before the first shared store
    int col[WIN_COLS];
#pragma unroll
    for (int j = 0; j < WIN_COLS; ++j) {
        col[j] = min(max(c0 - HALF + lane + 32 * j, 0), w - 1);
    }
    float v[WIN_ROWS][WIN_COLS];
#pragma unroll
    for (int i = 0; i < WIN_ROWS; ++i) {
        const int rr = min(max(r0 - HALF + warp + WARPS_B * i, 0), h - 1);
        const float* row = src + (size_t)rr * w;
#pragma unroll
        for (int j = 0; j < WIN_COLS; ++j) {
            v[i][j] = (warp + WARPS_B * i < BW_R && lane + 32 * j < BW_C)
                          ? __ldg(row + col[j]) : 0.0f;
        }
    }
#pragma unroll
    for (int i = 0; i < WIN_ROWS; ++i) {
#pragma unroll
        for (int j = 0; j < WIN_COLS; ++j) {
            if (warp + WARPS_B * i < BW_R && lane + 32 * j < BW_C) {
                win[(warp + WARPS_B * i) * BW_S + lane + 32 * j] = v[i][j];
            }
        }
    }
    __syncthreads();

    // vertical: a thread a window column and RUN output rows
    for (int it = tid; it < BW_C * (BT_R / RUN); it += BLUR_THREADS) {
        const int c = it % BW_C, rb = it / BW_C * RUN;
        float x[RUN + 2 * HALF], y[RUN];
#pragma unroll
        for (int j = 0; j < RUN + 2 * HALF; ++j) {
            x[j] = win[(rb + j) * BW_S + c];
        }
        blur_run(x, k, y);
#pragma unroll
        for (int o = 0; o < RUN; ++o) mid[(rb + o) * BW_S + c] = y[o];
    }
    __syncthreads();

    // horizontal: a thread an output row (the lane) and RUN columns
    {
        const int cb = warp * RUN;
        float x[RUN + 2 * HALF], y[RUN];
#pragma unroll
        for (int j = 0; j < RUN + 2 * HALF; ++j) {
            x[j] = mid[lane * BW_S + cb + j];
        }
        blur_run(x, k, y);
#pragma unroll
        for (int o = 0; o < RUN; ++o) win[lane * BO_S + cb + o] = y[o];
    }
    __syncthreads();

    // out: a warp a row, a lane columns lane and lane + 32
    float* dst = lv.out + frame;
#pragma unroll
    for (int i = 0; i < BT_R / WARPS_B; ++i) {
        const int rt = warp + WARPS_B * i, r = r0 + rt;
#pragma unroll
        for (int j = 0; j < BT_C / 32; ++j) {
            const int c = c0 + lane + 32 * j;
            if (r < h && c < w) {
                dst[(size_t)r * w + c] = win[rt * BO_S + lane + 32 * j];
            }
        }
    }
}

// The resize chain: levels 1..n of the pyramid, each from the one before,
// in one launch.  A cluster of CTAs takes one frame (grid (cluster, B));
// each CTA runs GROUPS independent groups of GROUP threads (8 warps), each
// group an output tile of TO_R x TO_C at a time: the tile's input window
// (the rows and columns its bands cover) and its bands are copied into
// shared memory with cp.async while the group computes the tile before
// (two stages); the rows' band runs into a second shared tile (the
// window's columns) and the columns' band out of it.  In the rows pass a
// lane keeps one output row (its first index and taps in registers) and
// walks the window's columns; in the columns pass a thread keeps one
// output column and walks the rows: a tap is one shared load and one
// fused multiply-add, and no index is divided.  A cluster barrier
// (release / acquire) separates one level from the next, which reads the
// previous level back through L2.
constexpr int CHAIN_THREADS = 1024;
constexpr int GROUP = 256;
constexpr int GROUPS = CHAIN_THREADS / GROUP;
constexpr int GROUP_WARPS = GROUP / 32;
constexpr int TO_R = 32;  // a lane a row; features/pyramid.py::CHAIN_TILE
constexpr int TO_C = 64;
constexpr int COL_ROWS = GROUP / TO_C;  // row phases of the columns pass
constexpr int MAX_LEVELS = 16;
constexpr int META = 10;  // ints a level in the host metadata

struct ChainLevel {
    int hi, wi, ho, wo;
    int rf, rw, rT;  // the rows' band: word offsets of first, weights; taps
    int cf, cw, cT;  // the columns' band
    size_t out_off;  // float offset of the level's (B, ho, wo) block
};

struct Chain {
    ChainLevel lv[MAX_LEVELS];
    int n;   // levels after level 0
    int nr;  // the largest input window of a tile: rows
    int nc;  // the shared tiles' row stride (odd, >= the window's columns)
    int bw;  // words of a tile's bands: TO_R + TO_C firsts, their taps
};

// one output tile of a level and the input window its bands cover
struct Tile {
    int r0, c0, nro, nco;  // output origin and extent
    int r_lo, c_lo, nr, nc;  // input window origin and extent
};

__device__ __forceinline__ Tile tile_at(const ChainLevel& L,
                                        const int* __restrict__ tab,
                                        int tile, int tc) {
    Tile t;
    t.r0 = tile / tc * TO_R;
    t.c0 = tile % tc * TO_C;
    t.nro = min(TO_R, L.ho - t.r0);
    t.nco = min(TO_C, L.wo - t.c0);
    t.r_lo = __ldg(tab + L.rf + t.r0);
    t.nr = min(__ldg(tab + L.rf + t.r0 + t.nro - 1) + L.rT - 1, L.hi - 1)
           - t.r_lo + 1;
    t.c_lo = __ldg(tab + L.cf + t.c0);
    t.nc = min(__ldg(tab + L.cf + t.c0 + t.nco - 1) + L.cT - 1, L.wi - 1)
           - t.c_lo + 1;
    return t;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src)
                 : "memory");
}

// the tile's window (row stride nc_max; a warp a row) and bands into one
// stage: [window][rows' first (TO_R)][rows' taps][columns' first][taps]
__device__ __forceinline__ void stage_tile(float* stage, const Tile& T,
                                           const ChainLevel& L,
                                           const float* src, const int* tab,
                                           int nc_max, int nr_max, int t) {
    const int lane = t & 31;
    for (int rr = t >> 5; rr < T.nr; rr += GROUP_WARPS) {
        const float* row = src + (size_t)(T.r_lo + rr) * L.wi + T.c_lo;
        float* to = stage + rr * nc_max;
        for (int cc = lane; cc < T.nc; cc += 32) cp_async4(to + cc, row + cc);
    }
    int* band = reinterpret_cast<int*>(stage + nr_max * nc_max);
    const int n[4] = {T.nro, T.nro * L.rT, T.nco, T.nco * L.cT};
    const int from[4] = {L.rf + T.r0, L.rw + T.r0 * L.rT, L.cf + T.c0,
                         L.cw + T.c0 * L.cT};
    const int to[4] = {0, TO_R, TO_R * (1 + L.rT),
                       TO_R * (1 + L.rT) + TO_C};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        for (int e = t; e < n[s]; e += GROUP) {
            cp_async4(band + to[s] + e, tab + from[s] + e);
        }
    }
}

// one output of a band: w[0] x[f] then += w[q] x[min(f + q, last)], one
// rounding a tap (the twin's order; the first tap a product, so that a
// signed zero stays as the twin keeps it); x strided by ``step``.  kT > 0:
// the taps in registers; 0: T taps read from shared memory
template <int kT>
struct Taps {
    float w[kT];
    __device__ __forceinline__ Taps(const float* src, int) {
#pragma unroll
        for (int q = 0; q < kT; ++q) w[q] = src[q];
    }
    __device__ __forceinline__ float operator()(const float* x, int f,
                                                int last, int step) const {
        float acc = __fmul_rn(w[0], x[f * step]);
#pragma unroll
        for (int q = 1; q < kT; ++q) {
            acc = __fmaf_rn(w[q], x[min(f + q, last) * step], acc);
        }
        return acc;
    }
};

template <>
struct Taps<0> {
    const float* w;
    int T;
    __device__ __forceinline__ Taps(const float* src, int n) : w(src), T(n) {}
    __device__ __forceinline__ float operator()(const float* x, int f,
                                                int last, int step) const {
        float acc = __fmul_rn(w[0], x[f * step]);
        for (int q = 1; q < T; ++q) {
            acc = __fmaf_rn(w[q], x[min(f + q, last) * step], acc);
        }
        return acc;
    }
};

// the rows pass: lane r of each warp keeps output row r, the warps split
// the window's columns
template <int kT>
__device__ __forceinline__ void rows_pass(const float* win, const int* band,
                                          float* mid, const Tile& T,
                                          const ChainLevel& L, int nc_max,
                                          int t) {
    const int r = t & 31;
    if (r >= T.nro) return;
    const Taps<kT> taps(
        reinterpret_cast<const float*>(band) + TO_R + r * L.rT, L.rT);
    const int f = band[r] - T.r_lo, last = L.hi - 1 - T.r_lo;
    for (int cc = t >> 5; cc < T.nc; cc += GROUP_WARPS) {
        mid[r * nc_max + cc] = taps(win + cc, f, last, nc_max);
    }
}

// the columns pass: a thread keeps one output column, COL_ROWS threads
// split the tile's rows
template <int kT>
__device__ __forceinline__ void cols_pass(const float* mid, const int* band,
                                          float* dst, const Tile& T,
                                          const ChainLevel& L, int nc_max,
                                          int t) {
    const int oc = t % TO_C;
    if (oc >= T.nco) return;
    const int* cb = band + TO_R * (1 + L.rT);
    const Taps<kT> taps(
        reinterpret_cast<const float*>(cb) + TO_C + oc * L.cT, L.cT);
    const int f = cb[oc] - T.c_lo, last = L.wi - 1 - T.c_lo;
    float* col = dst + (size_t)T.r0 * L.wo + T.c0 + oc;
    for (int rr = t / TO_C; rr < T.nro; rr += COL_ROWS) {
        col[(size_t)rr * L.wo] = taps(mid + rr * nc_max, f, last, 1);
    }
}

__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GROUP) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(CHAIN_THREADS)
pyramid_chain_kernel(const float* img, float* out,
                     const int* __restrict__ tab, Chain ch) {
    extern __shared__ float smem[];
    const int g = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
    const int stage_words = ch.nr * ch.nc + ch.bw;
    float* stages = smem + (size_t)g * (2 * stage_words + TO_R * ch.nc);
    float* mid = stages + 2 * stage_words;
    const int b = blockIdx.y;
    const int worker = blockIdx.x * GROUPS + g;
    const int workers = gridDim.x * GROUPS;
    for (int l = 0; l < ch.n; ++l) {
        const ChainLevel L = ch.lv[l];
        const float* src = (l == 0 ? img : out + ch.lv[l - 1].out_off)
                           + (size_t)b * L.hi * L.wi;
        float* dst = out + L.out_off + (size_t)b * L.ho * L.wo;
        const int tc = (L.wo + TO_C - 1) / TO_C;
        const int tiles = (L.ho + TO_R - 1) / TO_R * tc;
        int tile = worker, k = 0;
        Tile cur;
        if (tile < tiles) {
            cur = tile_at(L, tab, tile, tc);
            stage_tile(stages, cur, L, src, tab, ch.nc, ch.nr, t);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        while (tile < tiles) {
            const int next = tile + workers;
            Tile nxt;
            if (next < tiles) {
                nxt = tile_at(L, tab, next, tc);
                stage_tile(stages + (k ^ 1) * stage_words, nxt, L, src, tab,
                           ch.nc, ch.nr, t);
            }
            asm volatile("cp.async.commit_group;" ::: "memory");
            asm volatile("cp.async.wait_group 1;" ::: "memory");
            group_sync(g);
            const float* win = stages + k * stage_words;
            const int* band = reinterpret_cast<const int*>(
                win + ch.nr * ch.nc);
            if (L.rT == 3) {
                rows_pass<3>(win, band, mid, cur, L, ch.nc, t);
            } else {
                rows_pass<0>(win, band, mid, cur, L, ch.nc, t);
            }
            group_sync(g);
            if (L.cT == 3) {
                cols_pass<3>(mid, band, dst, cur, L, ch.nc, t);
            } else {
                cols_pass<0>(mid, band, dst, cur, L, ch.nc, t);
            }
            group_sync(g);
            tile = next;
            cur = nxt;
            k ^= 1;
        }
        if (l + 1 < ch.n) cluster_sync();
    }
}

}  // namespace

// imgs, outs: n_levels pointers to (B, h, w) float32 levels and their
// blurred images, contiguous, on the device; plan: (h, w, tiles across,
// first tile) per level, n_tiles the tiles a frame
// (features/pyramid.py::blur_tile_plan); taps: the 7 float32 taps (host).
VSG_API int vsg_blur_levels(const float* const* imgs, float* const* outs,
                            const int* plan, int n_levels, int n_tiles,
                            int B, const float* taps, cudaStream_t stream) {
    if (B == 0 || n_levels == 0) return 0;
    if (n_levels > BLUR_MAX_LEVELS || B > 65535 || n_tiles < 1) {
        return (int)cudaErrorInvalidValue;
    }
    BlurLevels L = {};
    L.n = n_levels;
    for (int t = 0; t < TAPS; ++t) L.taps[t] = taps[t];
    for (int l = 0; l < n_levels; ++l) {
        const int* p = plan + 4 * l;
        if (p[0] < 1 || p[1] < 1) return (int)cudaErrorInvalidValue;
        L.lv[l] = BlurLevel{imgs[l], outs[l], p[0], p[1], p[2], p[3]};
    }
    blur_levels_kernel<<<dim3(n_tiles, B), BLUR_THREADS, 0, stream>>>(L);
    return (int)cudaGetLastError();
}

// img: (B, h, w) f32 (level 0); out: levels 1..n, level-major, each a
// (B, h_l, w_l) block.  tab: the packed bands on the device (int32
// first indices, float32 weights); meta: n host rows of META ints (hi,
// wi, ho, wo, rows first / weights offsets and taps, columns the same);
// nr, nc: the largest input window of a tile; cluster: CTAs a frame (8,
// or 16 as a non-portable cluster size), 0 to choose by occupancy.
VSG_API int vsg_pyramid(const float* img, float* out, int B, const int* tab,
                        const int* meta, int n, int nr, int nc, int cluster,
                        cudaStream_t stream) {
    if (B == 0 || n == 0) return 0;
    if (n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    Chain ch;
    ch.n = n;
    ch.nr = nr;
    ch.nc = nc | 1;  // odd: the rows pass's 32 rows fall in distinct banks
    int taps = 1;
    size_t off = 0;
    for (int l = 0; l < n; ++l) {
        const int* m = meta + META * l;
        ChainLevel& L = ch.lv[l];
        L.hi = m[0];
        L.wi = m[1];
        L.ho = m[2];
        L.wo = m[3];
        L.rf = m[4];
        L.rw = m[5];
        L.rT = m[6];
        L.cf = m[7];
        L.cw = m[8];
        L.cT = m[9];
        L.out_off = off;
        off += (size_t)B * L.ho * L.wo;
        taps = max(taps, max(L.rT, L.cT));
    }
    ch.bw = (TO_R + TO_C) * (1 + taps);
    const size_t shmem =
        sizeof(float) * GROUPS
        * (2 * ((size_t)ch.nr * ch.nc + ch.bw) + (size_t)TO_R * ch.nc);
    cudaError_t err = cudaFuncSetAttribute(
        pyramid_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            pyramid_chain_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(CHAIN_THREADS, 1, 1);
    cfg.dynamicSmemBytes = shmem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cluster == 0) {
        // 16 CTAs a frame when every frame's cluster of 16 fits on the card
        // at once, else the portable 8 (queried once per shared size)
        static size_t queried = 0;
        static int fit16 = 0;
        if (queried != shmem) {
            cfg.gridDim = dim3(16, 1, 1);
            attr[0].val.clusterDim.x = 16;
            err = cudaOccupancyMaxActiveClusters(&fit16, pyramid_chain_kernel,
                                                 &cfg);
            if (err != cudaSuccess) return (int)err;
            queried = shmem;
        }
        cluster = B <= fit16 ? 16 : 8;
    }
    cfg.gridDim = dim3(cluster, B, 1);
    attr[0].val.clusterDim.x = cluster;
    err = cudaLaunchKernelEx(&cfg, pyramid_chain_kernel, img, out, tab, ch);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
