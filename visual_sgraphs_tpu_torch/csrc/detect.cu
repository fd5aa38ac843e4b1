// K3: ORB keypoint selection for every budgeted pyramid level of every
// frame of an extraction, in one launch.
//
// Replaces visual_sgraphs_tpu/features/orb.py:90 _detect_level, and the
// per-level stack / full / concatenate of orb.py:201-227 (extract_orb):
// each level's FAST score image (K2's output) is cut into cs x cs cells
// (zero-padded past the image), each cell keeps its two best pixels, and
// the level keeps the `budget` best of those 2C candidates with value >=
// min_thresh flagged valid (padded with zeros when 2C < budget).  Both
// selections follow lax.top_k's order: value descending, lower index
// first on ties (the in-cell row-major index, then the candidate index
// cell * 2 + j).  The kernel writes straight into the extraction's
// (B, n_out) arrays at each level's offset: rc, response, valid, the
// level-0 pixel (float32(c) * float32(scale^lv), float32(r) * ...) and the
// level index.
//
// What bounds it here: latency.  A 480x640 frame's 8 levels are 4 MB of
// scores (32 MB for a batch of 8) and at most 600 candidates a level (1840
// at 720x1280); the selection ranks up to MAX_CAND candidates a level (the
// keys in dynamic shared memory, sized by the launch's largest level).
//
// Design: the levels' descriptors (score pointer, h, w, budget, output
// offset, level, scale) go in a by-value kernel parameter, so a launch
// needs no host-to-device copy.  One cluster of 8 CTAs a (frame, level):
// - a candidate is a 64-bit key, the value's order-preserving bits above
//   the complement of its index, so that comparing keys is lax.top_k's
//   order, with no branch;
// - each warp takes cells in turn across the cluster (64 warps); with
//   cells up to 32 wide a lane reads its column of the cell's 32 rows
//   (128-byte row loads, all in flight at once) and takes the best two of
//   its 32 keys by a pairwise tree (no serial chain); wider cells' lanes
//   stride over the columns, row by row (a second instantiation of the
//   kernel, chosen on the host); the warp merges the lanes' pairs by
//   shuffles, so each cell's top-2 is exact;
// - each cell's two candidates go at once, re-keyed by candidate index,
//   to every CTA of the cluster at their index (distributed shared
//   memory);
// - each CTA ranks its eighth of the candidates by counting the keys
//   above each (four threads a candidate) and writes a candidate whose
//   rank is below the budget at that rank: no sort, no leader.
// The cluster barrier that makes the CTAs' memory safe to write is split:
// arrived at the start, waited on after a warp's first cell is read.
// Exact against the twin.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int CLUSTER = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// candidates a level at most: a key and a pixel (12 bytes) each in the
// 227 KB of dynamic shared memory a CTA may take
constexpr int MAX_CAND = 232448 / 12;
constexpr int GROUP = 4;  // threads that count one candidate's rank

struct LevelDesc {
    const float* score;  // (B, h, w)
    int h, w, budget, offset, level;
    float scale;  // float32(scale ** level)
};

struct Levels {
    LevelDesc lv[MAX_LEVELS];
};

// A candidate as a 64-bit key that orders as lax.top_k does: the value's
// order-preserving bits (±0 equal) above the complement of its index, so a
// larger key is a larger value or, on a tie, a lower index.
__device__ __forceinline__ unsigned long long cand_key(float v,
                                                       unsigned int idx) {
    unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (0xffffffffu - idx);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
    const unsigned int u = (unsigned int)(k >> 32);
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned int key_index(unsigned long long k) {
    return 0xffffffffu - (unsigned int)k;
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
    return a < b ? b : a;
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
    return a < b ? a : b;
}

// the best two of two best-two lists (x1 >= x2, y1 >= y2) into (x1, x2)
__device__ __forceinline__ void merge2(unsigned long long& x1,
                                       unsigned long long& x2,
                                       unsigned long long y1,
                                       unsigned long long y2) {
    const unsigned long long lo = kmin(x1, y1);
    x1 = kmax(x1, y1);
    x2 = kmax(lo, kmax(x2, y2));
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the best two keys of a cell up to 32 wide, in every lane of the warp
// once merged: a lane's column of the cell's 32 rows, reduced pairwise
__device__ __forceinline__ void cell_top2_narrow(
    const float* img, int h, int w, int cs, int y0, int x0, int lane,
    unsigned long long& t1, unsigned long long& t2) {
    const int c = x0 + lane;
    const bool col_in = lane < cs && c < w;
    // every load issued before the first is used: addresses clamped into
    // the image, values past it (the cells' padding) zeroed after
    const float* col = img + min(c, w - 1);
    float v[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
        v[r] = __ldg(col + (size_t)min(y0 + r, h - 1) * w);
    }
    // this lane's keys (0, below every real key, outside the cell)
    unsigned long long k1[16], k2[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        unsigned long long kk[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = 2 * i + hh;
            const float x = col_in && y0 + r < h ? v[r] : 0.0f;
            kk[hh] = r < cs && lane < cs ? cand_key(x, r * cs + lane) : 0ull;
        }
        k1[i] = kmax(kk[0], kk[1]);
        k2[i] = kmin(kk[0], kk[1]);
    }
#pragma unroll
    for (int wd = 8; wd > 0; wd >>= 1) {
#pragma unroll
        for (int i = 0; i < wd; ++i) {
            merge2(k1[i], k2[i], k1[i + wd], k2[i + wd]);
        }
    }
    t1 = k1[0];
    t2 = k2[0];
}

// the same for a cell wider than 32: lanes stride over its columns, row
// by row, each keeping its best two
__device__ __forceinline__ void cell_top2_wide(
    const float* img, int h, int w, int cs, int y0, int x0, int lane,
    unsigned long long& t1, unsigned long long& t2) {
    t1 = t2 = 0ull;
    for (int r = 0; r < cs; ++r) {
        const int y = y0 + r;
        const float* row = img + (size_t)min(y, h - 1) * w;
        for (int cc = lane; cc < cs; cc += 32) {
            const int c = x0 + cc;
            const float x = y < h && c < w ? __ldg(row + c) : 0.0f;
            merge2(t1, t2, cand_key(x, (unsigned int)(r * cs + cc)), 0ull);
        }
    }
}

template <bool WIDE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
detect_kernel(const __grid_constant__ Levels levels, int cs, int n_out,
              int max_cand, float min_thresh, int* __restrict__ out_rc,
              float* __restrict__ out_v, uint8_t* __restrict__ out_valid,
              float* __restrict__ out_uv, int* __restrict__ out_level) {
    // max_cand keys, then their pixels (row << 16 | col)
    extern __shared__ unsigned long long s_key[];
    int* s_rc = reinterpret_cast<int*>(s_key + max_cand);

    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const LevelDesc& L = levels.lv[blockIdx.x / CLUSTER];
    const int b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ncy = (L.h + cs - 1) / cs, ncx = (L.w + cs - 1) / cs;
    const int n_cells = ncy * ncx, n_cand = 2 * n_cells;
    cluster_arrive();

    // ---- each warp's cells: the two best (value, in-cell index) keys,
    // into every CTA's keys at their index: lane 2 t + j writes candidate
    // j to CTA t
    const float* img = L.score + (size_t)b * L.h * L.w;
    bool waited = false;
    for (int cell = rank * WARPS + warp; cell < n_cells;
         cell += CLUSTER * WARPS) {
        const int y0 = (cell / ncx) * cs, x0 = (cell % ncx) * cs;
        unsigned long long k1, k2;
        if constexpr (WIDE) {
            cell_top2_wide(img, L.h, L.w, cs, y0, x0, lane, k1, k2);
        } else {
            cell_top2_narrow(img, L.h, L.w, cs, y0, x0, lane, k1, k2);
        }
        for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o1 =
                __shfl_xor_sync(0xffffffffu, k1, off);
            const unsigned long long o2 =
                __shfl_xor_sync(0xffffffffu, k2, off);
            merge2(k1, k2, o1, o2);
        }
        if (!waited) {  // warp-uniform: the cells are the warp's
            cluster_wait();
            waited = true;
        }
        if (lane < 2 * CLUSTER) {
            unsigned long long* key = cl.map_shared_rank(s_key, lane >> 1);
            int* rcs = cl.map_shared_rank(s_rc, lane >> 1);
            const int j = lane & 1;
            const unsigned long long kc = j ? k2 : k1;
            const int p = (int)key_index(kc);
            const int idx = 2 * cell + j;
            key[idx] = (kc & 0xffffffff00000000ull) |
                       (0xffffffffu - (unsigned int)idx);
            rcs[idx] = ((y0 + p / cs) << 16) | (x0 + p % cs);
        }
    }
    if (!waited) cluster_wait();
    cluster_arrive();
    cluster_wait();

    // ---- this CTA's eighth of the candidates: rank = the keys above it,
    // counted by GROUP threads over strided shares; a rank below the
    // budget is the candidate's row
    const size_t row0 = (size_t)b * n_out + L.offset;
    const int chunk = (n_cand + CLUSTER - 1) / CLUSTER;
    const int lo = rank * chunk, hi = min(n_cand, lo + chunk);
    for (int base = lo; base < hi; base += THREADS / GROUP) {
        const int idx = base + tid / GROUP;
        const int g = tid % GROUP;
        const unsigned long long mine = idx < hi ? s_key[idx] : ~0ull;
        int above = 0;
        for (int i = g; i < n_cand; i += GROUP) above += s_key[i] > mine;
#pragma unroll
        for (int off = 1; off < GROUP; off <<= 1) {
            above += __shfl_xor_sync(0xffffffffu, above, off);
        }
        if (idx < hi && g == 0 && above < L.budget) {
            const float v = key_value(mine);
            const int r = s_rc[idx] >> 16, c = s_rc[idx] & 0xffff;
            const size_t o = row0 + above;
            out_rc[2 * o] = r;
            out_rc[2 * o + 1] = c;
            out_v[o] = v;
            out_valid[o] = (uint8_t)(v >= min_thresh);
            if (out_uv != nullptr) {
                out_uv[2 * o] = __fmul_rn((float)c, L.scale);
                out_uv[2 * o + 1] = __fmul_rn((float)r, L.scale);
            }
            if (out_level != nullptr) out_level[o] = L.level;
        }
    }
    // rows past the candidates (2C < budget): zeros, as the reference pads
    if (rank == 0) {
        for (int p = n_cand + tid; p < L.budget; p += THREADS) {
            const size_t o = row0 + p;
            out_rc[2 * o] = 0;
            out_rc[2 * o + 1] = 0;
            out_v[o] = 0.0f;
            out_valid[o] = 0;
            if (out_uv != nullptr) {
                out_uv[2 * o] = 0.0f;
                out_uv[2 * o + 1] = 0.0f;
            }
            if (out_level != nullptr) out_level[o] = L.level;
        }
    }
}

}  // namespace

// scores: n_levels device pointers to (B, h, w) f32 score images; dims:
// n_levels x (h, w, budget, offset, level) on the host; scales: n_levels
// float32(scale ** level) on the host; cs >= 1, every level's
// 2 ceil(h / cs) ceil(w / cs) <= MAX_CAND (19370) and h, w < 65536.
// Writes rows offset .. offset + budget - 1 of out_rc (B, n_out, 2) i32,
// out_v
// (B, n_out) f32, out_valid (B, n_out) bool and, where not NULL, out_uv
// (B, n_out, 2) f32 and out_level (B, n_out) i32.
VSG_API int vsg_detect_levels(const float* const* scores, const int* dims,
                              const float* scales, int n_levels, int B,
                              int n_out, int cs, float min_thresh,
                              int* out_rc, float* out_v, uint8_t* out_valid,
                              float* out_uv, int* out_level,
                              cudaStream_t stream) {
    if (B == 0 || n_levels == 0) return 0;
    if (n_levels > MAX_LEVELS || cs < 1) return (int)cudaErrorInvalidValue;
    Levels lv = {};
    long long max_cand = 0;
    for (int l = 0; l < n_levels; ++l) {
        const int* d = dims + 5 * l;
        const long long n_cand = 2LL * ((d[0] + cs - 1) / cs) *
                                 ((d[1] + cs - 1) / cs);
        if (n_cand > MAX_CAND || d[0] >= 65536 || d[1] >= 65536) {
            return (int)cudaErrorInvalidValue;
        }
        max_cand = n_cand > max_cand ? n_cand : max_cand;
        lv.lv[l] = LevelDesc{scores[l], d[0], d[1], d[2], d[3], d[4],
                             scales[l]};
    }
    const size_t smem = (size_t)max_cand * 12;
    const bool wide = cs > 32;
    void (*kern)(const Levels, int, int, int, float, int*, float*, uint8_t*,
                 float*, int*) =
        wide ? detect_kernel<true> : detect_kernel<false>;
    static size_t smem_set[2] = {48 * 1024, 48 * 1024};  // default limits
    if (smem > smem_set[wide]) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set[wide] = smem;
    }
    kern<<<dim3(CLUSTER * n_levels, B), THREADS, smem, stream>>>(
        lv, cs, n_out, (int)max_cand, min_thresh, out_rc, out_v, out_valid,
        out_uv, out_level);
    return (int)cudaGetLastError();
}
