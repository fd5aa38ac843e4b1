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
