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
// scratch images cost far more in launches and host time.
//
// Design: the resize's bands (first source index and up to T float32
// weights per output, T = 3 at 1/1.2) of every level, rows and columns,
// are computed once per (h, w, levels, scale) on the host from the same
// float64-derived float32 weights as the twin's and packed into one
// device table.  One launch builds levels 1..n of the batch into one
// buffer: a thread-block cluster a frame, a cluster barrier between
// levels, each tile's rows pass kept in shared memory (no scratch image).
// Each output accumulates its taps in order, the first a product and each
// next one fused multiply-add (__fmaf_rn), the rounding of a matrix
// product's dot over the dense weights (the zero weights add nothing);
// the twin emulates the fused step in float64.  The blur loads a
// (TH + 6) x (TW + 6) tile with clamped coordinates into shared memory,
// runs the vertical taps into a second tile and the horizontal taps out
// of it, each product and sum written with __fmul_rn / __fadd_rn in the
// twin's order (nvcc would contract a * b + c into an FMA).  Both are
// bitwise equal to the twin on the card but for a rare double rounding in
// the twin's emulation.
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

// img, out: (B, h, w) f32; taps: (7,) f32.
VSG_API int vsg_blur(const float* img, const float* taps, float* out, int B,
                     int h, int w, cudaStream_t stream) {
    if (B == 0) return 0;
    dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
    blur_kernel<<<grid, dim3(TW, TH), 0, stream>>>(img, taps, out, h, w);
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
