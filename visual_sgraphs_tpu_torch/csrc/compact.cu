// K7: sync-free fixed-size compaction, one launch a call, two entries.
//
// Replaces the reference's jnp.nonzero(mask, size=size, fill_value=-1)
// (visual_sgraphs_tpu/slam/tracking.py:67, optim/fast_ba.py:119,249,
// slam/mapping.py:141,335,426,540, inertial/vi_ba.py:115): the indices of
// the first `size` True entries of a 1-D bool mask, ascending, padded with
// -1.  torch.nonzero would synchronise the host to size its output.
// - vsg_compact: compact_true(mask, size) on a bool mask of n entries.
// - vsg_compact_observed: compact_observed(m, kf_ids, kf_mask, size), the
//   same compaction of observed_mask(m, kf_ids, kf_mask) & m.pt_valid
//   (slam/map_state.py:156-163 in the reference), whose mask the plain
//   composition builds in ~9 eager operations (two row gathers, a where,
//   an N + 1 fill, an index_fill_, an AND) before the compaction.
// The observed entry writes int64 (the reference's dtype) or, for the
// callers that cast the ids to int32 next, int32.
//
// What bounds it here: latency.  The plain mask is n <= 32768 bytes, the
// observed entry reads L x F observation ids and keypoint flags (L = 11,
// F = 1000: ~55 KB) and n bytes of pt_valid; a few microseconds of memory
// traffic at most.  The parent kernel walked the mask in 32 serial chunks
// of 1024 entries, each a dependent load, a ballot, a warp-0 scan and four
// barriers (~23 us on the tracking table's mask).
//
// Design: one CTA of 1024 threads; thread t owns WPT consecutive 32-entry
// words (entries [32 WPT t, 32 WPT (t + 1))), WPT the least power of two
// with 1024 WPT words covering n (compact_plan in slam/map_state.py; 1 up
// to n = 32768; WPT = 64, past ~1M entries, spills its words to local
// memory).
// - Plain entry: each thread loads its words' mask bytes with 16-byte
//   loads, all issued at once, and packs them to 32-bit words in
//   registers (per 4 bytes: __vcmpne4, then one multiply gathers the 4
//   flags into a nibble).
// - Observed entry: the membership of the N points is a bitmap of N / 8
//   bytes in shared memory (4 KB at N = 32768).  Each thread zeroes its
//   words and packs its pt_valid words into registers; after one barrier
//   the L x F entries are read 4 at a time (an int4 of ids and the 4
//   keypoint flags; a thread's quads all loaded before any is applied)
//   and each observed id sets its bit with a shared atomicOr; after a
//   second barrier each thread ANDs its bitmap words with pt_valid.  The
//   rows of masked keyframes are not read.  Duplicate kf_ids set the same
//   bits again.  Observation ids outside [0, N) are dropped, as the
//   reference's .at[flat + 1].set drops ids past N (an id below -1 would
//   wrap there and raise in the twin's index_fill_; kf_obs_pt holds -1 or
//   a point id below N, so no caller produces one); a kf_id outside
//   [0, K) is skipped (the reference clamps the gather, the twin raises;
//   every caller's ids are slots).
// - Both: each thread counts its bits (__popc), one block-wide exclusive
//   scan (warp shuffles, the 32 warp sums through shared memory: one
//   barrier) gives its first output position, and it stages the indices
//   of its set bits, in order, in shared memory while the position is
//   below `size` (4 bytes a slot); after a barrier the block writes the
//   output coalesced, -1 from min(total, size).  Written straight from
//   each thread's positions, the scattered 8-byte stores of one SM took
//   ~10k cycles at 6571 ids (clock64 stamps, PERF.md §6), ~70 % of
//   the call; staged, ~4k.  The output is bitwise equal to the twin's
//   (cumsum + scatter) for every mask.
// Barriers a call: two (plain), four (observed).  No loop over the mask.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int NWARP = THREADS / 32;
// the observed entry's quads (4 observation entries) a thread loads
// before it applies any
constexpr int QUADS = 4;

// 4 bool bytes (0 / 1) -> 4 bits, byte i to bit i
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
    return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
    return pack4(v.x) | (pack4(v.y) << 4) | (pack4(v.z) << 8) |
           (pack4(v.w) << 12);
}

// word w of a bool array of n entries (entries 32 w .. 32 w + 31), 0 past
// the end; `vec`: the array starts on a 16-byte boundary
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ a,
                                              int n, int w, bool vec) {
    const int base = 32 * w;
    if (base >= n) return 0u;
    if (vec && base + 32 <= n) {
        const uint4* p = reinterpret_cast<const uint4*>(a + base);
        const uint4 lo = __ldg(p), hi = __ldg(p + 1);
        return pack16(lo) | (pack16(hi) << 16);
    }
    uint32_t word = 0u;
    const int m = min(32, n - base);
    for (int i = 0; i < m; ++i) {
        word |= (uint32_t)(__ldg(a + base + i) != 0) << i;
    }
    return word;
}

// Sets the bitmap bit of every observed, valid point id of the L rows
// kf_ids (masked by kf_mask) of the (K, F) tables obs / kp_valid.
__device__ void mark_observed(const int32_t* __restrict__ obs,
                              const uint8_t* __restrict__ kp_valid, int K,
                              int F, const long long* __restrict__ kf_ids,
                              const uint8_t* __restrict__ kf_mask, int L,
                              int n, uint32_t* bits) {
    const int tid = threadIdx.x;
    const bool vec = (F & 3) == 0 &&
                     ((uintptr_t)obs & 15) == 0 &&
                     ((uintptr_t)kp_valid & 3) == 0;
    // vector path: quads of 4 entries of one row; scalar path: 1 entry
    const int width = vec ? 4 : 1;
    const int per_row = F / width;
    const int items = L * per_row;
    for (int first = 0; first < items; first += THREADS * QUADS) {
        long long row_off[QUADS];
        // the rows first: kf_ids / kf_mask of each item (L1-resident)
#pragma unroll
        for (int j = 0; j < QUADS; ++j) {
            const int q = first + j * THREADS + tid;
            row_off[j] = -1;
            if (q < items) {
                const int l = q / per_row;
                const long long kf = __ldg(kf_ids + l);
                if (__ldg(kf_mask + l) && kf >= 0 && kf < K) {
                    row_off[j] =
                        kf * F + (long long)(q - l * per_row) * width;
                }
            }
        }
        // then every item's ids and flags, all loads in flight
        int4 ids[QUADS];
        uint32_t ok[QUADS];
#pragma unroll
        for (int j = 0; j < QUADS; ++j) {
            ids[j] = make_int4(-1, -1, -1, -1);
            ok[j] = 0u;
            if (row_off[j] < 0) continue;
            if (vec) {
                ids[j] = __ldg(
                    reinterpret_cast<const int4*>(obs + row_off[j]));
                ok[j] = __ldg(reinterpret_cast<const uint32_t*>(
                    kp_valid + row_off[j]));
            } else {
                ids[j].x = __ldg(obs + row_off[j]);
                ok[j] = __ldg(kp_valid + row_off[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < QUADS; ++j) {
            const int id4[4] = {ids[j].x, ids[j].y, ids[j].z, ids[j].w};
            const uint32_t flags = pack4(ok[j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int id = id4[i];
                if (((flags >> i) & 1u) && id >= 0 && id < n) {
                    atomicOr(bits + (id >> 5), 1u << (id & 31));
                }
            }
        }
    }
}

// The block-wide exclusive scan of the threads' bit counts and the
// writes: each thread stages the indices of its words' set bits at its
// positions below `size` in shared memory (`stage`, `size` ints), then
// the block writes out[0, size) coalesced, -1 from min(total, size).
template <int WPT>
__device__ void scan_and_write(const uint32_t (&words)[WPT], int w0,
                               int size, int* stage, int out32, void* out) {
    __shared__ int warp_sum[NWARP];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < WPT; ++k) cnt += __popc(words[k]);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    // every warp scans the 32 warp sums itself: no second barrier
    const int ws = warp_sum[lane];
    int wincl = ws;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wincl, off);
        if (lane >= off) wincl += y;
    }
    const int warp_base = __shfl_sync(0xffffffffu, wincl - ws, warp);
    const int total = __shfl_sync(0xffffffffu, wincl, 31);
    int pos = warp_base + incl - cnt;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        uint32_t x = words[k];
        const int base = 32 * (w0 + k);
        while (x != 0u && pos < size) {
            stage[pos++] = base + __ffs(x) - 1;
            x &= x - 1u;
        }
    }
    __syncthreads();
    const int m = min(total, size);
    if (out32) {
        int* o = static_cast<int*>(out);
        for (int p = tid; p < size; p += THREADS) o[p] = p < m ? stage[p] : -1;
    } else {
        long long* o = static_cast<long long*>(out);
        for (int p = tid; p < size; p += THREADS) {
            o[p] = p < m ? (long long)stage[p] : -1LL;
        }
    }
}

template <int WPT>
__global__ void __launch_bounds__(THREADS)
    compact_kernel(const uint8_t* __restrict__ mask, int n, int size,
                   long long* out) {
    extern __shared__ int stage[];
    const int w0 = threadIdx.x * WPT;
    const bool vec = ((uintptr_t)mask & 15) == 0;
    uint32_t words[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) words[k] = load_word(mask, n, w0 + k, vec);
    scan_and_write<WPT>(words, w0, size, stage, 0, out);
}

template <int WPT>
__global__ void __launch_bounds__(THREADS)
    compact_observed_kernel(const int32_t* __restrict__ obs,
                            const uint8_t* __restrict__ kp_valid, int K,
                            int F, const long long* __restrict__ kf_ids,
                            const uint8_t* __restrict__ kf_mask, int L,
                            const uint8_t* __restrict__ pt_valid, int n,
                            int size, int out32, void* out) {
    // the bitmap (n_words), then the staged ids (size)
    extern __shared__ uint32_t bits[];
    const int n_words = (n + 31) >> 5;
    const int w0 = threadIdx.x * WPT;
    const bool vec = ((uintptr_t)pt_valid & 15) == 0;
    uint32_t words[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        if (w0 + k < n_words) bits[w0 + k] = 0u;
        words[k] = load_word(pt_valid, n, w0 + k, vec);
    }
    __syncthreads();
    mark_observed(obs, kp_valid, K, F, kf_ids, kf_mask, L, n, bits);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        if (w0 + k < n_words) words[k] &= bits[w0 + k];
    }
    scan_and_write<WPT>(words, w0, size,
                        reinterpret_cast<int*>(bits + n_words), out32, out);
}

// Raises the kernel's dynamic shared-memory limit to `smem` once it needs
// more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int smem, size_t& set) {
    if ((size_t)smem <= set) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) set = (size_t)smem;
    return e;
}

template <int WPT>
int launch_true(const uint8_t* mask, int n, int size, int smem,
                long long* out, cudaStream_t stream) {
    static size_t smem_set = 48 * 1024;  // the default limit
    const cudaError_t e = allow_smem(compact_kernel<WPT>, smem, smem_set);
    if (e != cudaSuccess) return (int)e;
    compact_kernel<WPT><<<1, THREADS, smem, stream>>>(mask, n, size, out);
    return (int)cudaGetLastError();
}

template <int WPT>
int launch_observed(const int32_t* obs, const uint8_t* kp_valid, int K,
                    int F, const long long* kf_ids, const uint8_t* kf_mask,
                    int L, const uint8_t* pt_valid, int n, int size,
                    int smem, int out32, void* out, cudaStream_t stream) {
    static size_t smem_set = 48 * 1024;  // the default limit
    const cudaError_t e =
        allow_smem(compact_observed_kernel<WPT>, smem, smem_set);
    if (e != cudaSuccess) return (int)e;
    compact_observed_kernel<WPT><<<1, THREADS, smem, stream>>>(
        obs, kp_valid, K, F, kf_ids, kf_mask, L, pt_valid, n, size, out32,
        out);
    return (int)cudaGetLastError();
}

}  // namespace

#define VSG_WPT_CASES(X) X(1) X(2) X(4) X(8) X(16) X(32) X(64)

// mask: (n,) bool; out: (size,) int64; wpt, smem: compact_plan(n, size)
// (smem: the staged ids).
VSG_API int vsg_compact(const uint8_t* mask, int n, int size, int wpt,
                        int smem, long long* out, cudaStream_t stream) {
    if (size == 0) return 0;
    switch (wpt) {
#define VSG_CASE(W) \
    case W:         \
        return launch_true<W>(mask, n, size, smem, out, stream);
        VSG_WPT_CASES(VSG_CASE)
#undef VSG_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// obs: (K, F) int32 kf_obs_pt; kp_valid: (K, F) bool; kf_ids: (L,) int64;
// kf_mask: (L,) bool; pt_valid: (n,) bool; out: (size,) int64, or int32
// with out32; wpt, smem: compact_plan(n, size) (smem: the bitmap and the
// staged ids).
VSG_API int vsg_compact_observed(const int32_t* obs, const uint8_t* kp_valid,
                                 int K, int F, const long long* kf_ids,
                                 const uint8_t* kf_mask, int L,
                                 const uint8_t* pt_valid, int n, int size,
                                 int wpt, int smem, int out32, void* out,
                                 cudaStream_t stream) {
    if (size == 0) return 0;
    switch (wpt) {
#define VSG_CASE(W)                                                       \
    case W:                                                               \
        return launch_observed<W>(obs, kp_valid, K, F, kf_ids, kf_mask, L, \
                                  pt_valid, n, size, smem, out32, out,    \
                                  stream);
        VSG_WPT_CASES(VSG_CASE)
#undef VSG_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}
