// K3: ORB keypoint selection on one pyramid level, for a batch of frames.
//
// Replaces visual_sgraphs_tpu/features/orb.py:90 _detect_level: the FAST
// score image (K2's output) is cut into cs x cs cells (zero-padded past the
// image), each cell keeps its two best pixels, and the level keeps the
// `budget` best of those 2C candidates with value >= min_thresh flagged
// valid (padded with zeros when 2C < budget).  Both selections follow
// lax.top_k's order: value descending, lower index first on ties (the
// in-cell row-major index, then the candidate index cell * 2 + j).  The
// plain twin sorts every cell and the candidate list in full.
//
// What bounds it here: latency.  Level 0 of a 480x640 frame is 1.2 MB of
// scores and 600 candidates; the selection is a few hundred thousand
// comparisons.
//
// Design: kernel 1 gives each cell one warp; every lane keeps the best two
// of its strided pixels and the warp merges the lanes' pairs by shuffles,
// comparing (value, index) pairs, so the result is exact.  Kernel 2 gives
// each frame one block: the candidates' values go to shared memory and
// each candidate's rank is the number of candidates ahead of it in the
// order above; a candidate with rank < budget writes its row, column and
// value at that rank.  Exact against the twin.
#include "common.cuh"

#include <limits.h>

namespace {

struct Cand {
    float v;
    int i;
};

__device__ __forceinline__ bool ahead(Cand a, Cand b) {
    return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ void push(Cand c, Cand& b1, Cand& b2) {
    if (ahead(c, b1)) {
        b2 = b1;
        b1 = c;
    } else if (ahead(c, b2)) {
        b2 = c;
    }
}

__global__ void cell_top2_kernel(const float* __restrict__ score, int h,
                                 int w, int cs, int ncx, int n_cells,
                                 float* __restrict__ cand_v,
                                 int* __restrict__ cand_rc) {
    const int cell = blockIdx.x;
    const int b = blockIdx.y;
    const int lane = threadIdx.x;
    const float* img = score + (size_t)b * h * w;
    const int cy = cell / ncx;
    const int cx = cell % ncx;
    Cand b1{-INFINITY, INT_MAX}, b2{-INFINITY, INT_MAX};
    for (int p = lane; p < cs * cs; p += 32) {
        const int r = cy * cs + p / cs;
        const int c = cx * cs + p % cs;
        const float v = (r < h && c < w) ? img[r * w + c] : 0.0f;
        push(Cand{v, p}, b1, b2);
    }
    for (int off = 16; off > 0; off >>= 1) {
        Cand o1{__shfl_xor_sync(0xffffffffu, b1.v, off),
                __shfl_xor_sync(0xffffffffu, b1.i, off)};
        Cand o2{__shfl_xor_sync(0xffffffffu, b2.v, off),
                __shfl_xor_sync(0xffffffffu, b2.i, off)};
        push(o1, b1, b2);
        push(o2, b1, b2);
    }
    if (lane == 0) {
        const size_t base = (size_t)b * 2 * n_cells + 2 * cell;
        const Cand best[2] = {b1, b2};
        for (int j = 0; j < 2; ++j) {
            cand_v[base + j] = best[j].v;
            cand_rc[2 * (base + j) + 0] = cy * cs + best[j].i / cs;
            cand_rc[2 * (base + j) + 1] = cx * cs + best[j].i % cs;
        }
    }
}

__global__ void level_topk_kernel(const float* __restrict__ cand_v,
                                  const int* __restrict__ cand_rc,
                                  int n_cand, int budget, float min_thresh,
                                  int* __restrict__ out_rc,
                                  float* __restrict__ out_v,
                                  uint8_t* __restrict__ out_valid) {
    extern __shared__ float sv[];
    const int b = blockIdx.x;
    const float* cv = cand_v + (size_t)b * n_cand;
    const int* crc = cand_rc + (size_t)b * n_cand * 2;
    int* orc = out_rc + (size_t)b * budget * 2;
    float* ov = out_v + (size_t)b * budget;
    uint8_t* ovalid = out_valid + (size_t)b * budget;
    for (int i = threadIdx.x; i < n_cand; i += blockDim.x) sv[i] = cv[i];
    __syncthreads();
    const int k = min(budget, n_cand);
    for (int i = threadIdx.x; i < n_cand; i += blockDim.x) {
        const float vi = sv[i];
        int rank = 0;
        for (int j = 0; j < n_cand; ++j) {
            const float vj = sv[j];
            rank += (vj > vi || (vj == vi && j < i)) ? 1 : 0;
        }
        if (rank < k) {
            orc[2 * rank + 0] = crc[2 * i + 0];
            orc[2 * rank + 1] = crc[2 * i + 1];
            ov[rank] = vi;
            ovalid[rank] = vi >= min_thresh ? 1 : 0;
        }
    }
    for (int p = k + threadIdx.x; p < budget; p += blockDim.x) {
        orc[2 * p + 0] = 0;
        orc[2 * p + 1] = 0;
        ov[p] = 0.0f;
        ovalid[p] = 0;
    }
}

}  // namespace

// score: (B, h, w) f32.  cand_v: (B, 2C) f32 and cand_rc: (B, 2C, 2) i32
// scratch, C = ceil(h / cs) * ceil(w / cs).  out_rc: (B, budget, 2) i32,
// out_v: (B, budget) f32, out_valid: (B, budget) bool.
VSG_API int vsg_detect_level(const float* score, int B, int h, int w, int cs,
                             int budget, float min_thresh, float* cand_v,
                             int* cand_rc, int* out_rc, float* out_v,
                             uint8_t* out_valid, cudaStream_t stream) {
    if (B == 0 || budget == 0) return 0;
    const int ncy = (h + cs - 1) / cs;
    const int ncx = (w + cs - 1) / cs;
    const int n_cells = ncy * ncx;
    cell_top2_kernel<<<dim3(n_cells, B), 32, 0, stream>>>(
        score, h, w, cs, ncx, n_cells, cand_v, cand_rc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_cand = 2 * n_cells;
    const size_t smem = (size_t)n_cand * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            level_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    level_topk_kernel<<<B, 512, smem, stream>>>(
        cand_v, cand_rc, n_cand, budget, min_thresh, out_rc, out_v,
        out_valid);
    return (int)cudaGetLastError();
}
