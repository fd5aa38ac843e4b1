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
#include "compact.cuh"

namespace {

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
    compact_observed_block<WPT>(obs, kp_valid, K, F, kf_ids, kf_mask, L,
                                pt_valid, n, size, out32, out, bits);
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
