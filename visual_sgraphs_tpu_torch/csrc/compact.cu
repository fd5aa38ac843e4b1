// K7: sync-free fixed-size compaction, compact_true(mask, size).
//
// Replaces the reference's jnp.nonzero(mask, size=size, fill_value=-1)
// (visual_sgraphs_tpu/slam/tracking.py:67, optim/fast_ba.py:119,249,
// slam/mapping.py:141,335,540): the indices of the first `size` True
// entries of a 1-D bool mask, ascending, padded with -1.  torch.nonzero
// would synchronise the host to size its output; the plain twin is a cumsum
// plus a scatter, three launches and an N-sized int64 intermediate.
//
// What bounds it here: latency.  N <= 32768 bytes in and `size` int64 out
// are a few microseconds of memory traffic at most; the work is one scan.
//
// Design: one block of 1024 threads walks the mask in chunks of 1024.  Per
// chunk each warp ballots its flags, warp 0 scans the 32 warp counts, and
// each True entry writes its index at (running base + warp offset + rank in
// the warp).  The loop stops once `size` entries are written; the tail of
// the output is filled with -1.  One launch, exact.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void compact_kernel(const uint8_t* __restrict__ mask, int n,
                               int size, long long* __restrict__ out) {
    __shared__ int warp_off[32];
    __shared__ int base_s;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) base_s = 0;
    __syncthreads();
    for (int start = 0; start < n; start += THREADS) {
        const int i = start + tid;
        const bool v = i < n && mask[i] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, v);
        if (lane == 0) warp_off[warp] = __popc(bal);
        __syncthreads();
        if (warp == 0) {
            const int x = warp_off[lane];
            int incl = x;
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += y;
            }
            warp_off[lane] = incl - x;
        }
        __syncthreads();
        const int base = base_s;
        if (v) {
            const int pos = base + warp_off[warp] +
                            __popc(bal & ((1u << lane) - 1u));
            if (pos < size) out[pos] = (long long)i;
        }
        __syncthreads();
        // the last thread is lane 31 of the last warp: its ballot and
        // offset give the chunk's total
        if (tid == THREADS - 1) base_s = base + warp_off[31] + __popc(bal);
        __syncthreads();
        if (base_s >= size) break;
    }
    const int total = min(base_s, size);
    for (int p = total + tid; p < size; p += THREADS) out[p] = -1;
}

}  // namespace

// mask: (n,) bool; out: (size,) int64.
VSG_API int vsg_compact(const uint8_t* mask, int n, int size, long long* out,
                        cudaStream_t stream) {
    if (size == 0) return 0;
    compact_kernel<<<1, THREADS, 0, stream>>>(mask, n, size, out);
    return (int)cudaGetLastError();
}
