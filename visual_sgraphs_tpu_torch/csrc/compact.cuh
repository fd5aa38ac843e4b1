// K7's block routines (one CTA of 1024 threads), shared by compact.cu
// (K7's two entries) and fuse_obs.cu (K28's prologue, whose observed pass
// over the top-8 covisible keyframes is K7's observed entry).  See
// compact.cu for the design.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;  // one CTA's threads
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
                // kf_ids / kf_mask may lie in shared memory (K28)
                const long long kf = kf_ids[l];
                if (kf_mask[l] && kf >= 0 && kf < K) {
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

// K7's observed entry in one CTA: the first `size` ids of the valid points
// that the L rows kf_ids (masked by kf_mask; global or shared memory) of
// the (K, F) tables observe, ascending, -1 padded, into out (int64, or
// int32 with out32).  `bits`: n_words + size ints of shared memory (the
// membership bitmap, then the staged ids).  Every thread of the CTA calls
// it; four barriers.
template <int WPT>
__device__ void compact_observed_block(
    const int32_t* __restrict__ obs, const uint8_t* __restrict__ kp_valid,
    int K, int F, const long long* kf_ids, const uint8_t* kf_mask, int L,
    const uint8_t* __restrict__ pt_valid, int n, int size, int out32,
    void* out, uint32_t* bits) {
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

}  // namespace
