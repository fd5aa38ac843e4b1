// Shared helpers of the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (bound from Python with ctypes):
// it launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VSG_API extern "C" __attribute__((visibility("default")))

// Sum of one float over a warp (all 32 lanes active).
__device__ __forceinline__ float vsg_warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

// jnp.argmax / argmin order of a (value, index) candidate: a NaN counts as
// the extreme value, ties go to the lower index.
template <bool kMax>
__device__ __forceinline__ bool vsg_better(float a, int ia, float b,
                                           int ib) {
    const bool na = isnan(a), nb = isnan(b);
    if (na || nb) return na && (!nb || ia < ib);
    if (a != b) return kMax ? a > b : a < b;
    return ia < ib;
}

// The first arg-max (kMax) or arg-min of one block's (v, i) candidates,
// each thread's already reduced over its own strided share: on return
// every thread holds the winner.  All threads of the block must call it;
// ``sv`` / ``si`` are shared scratch of one entry per warp.
template <bool kMax>
__device__ void vsg_block_arg_best(float& v, int& i, float* sv, int* si) {
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (vsg_better<kMax>(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
    const int warp = threadIdx.x >> 5, n_warps = (blockDim.x + 31) >> 5;
    if ((threadIdx.x & 31) == 0) {
        sv[warp] = v;
        si[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < n_warps; ++w) {
            if (vsg_better<kMax>(sv[w], si[w], v, i)) {
                v = sv[w];
                i = si[w];
            }
        }
        sv[0] = v;
        si[0] = i;
    }
    __syncthreads();
    v = sv[0];
    i = si[0];
    __syncthreads();
}
