// K5: window-restricted Hamming matcher with best-2, ratio test and
// duplicate-target resolution.
//
// Replaces visual_sgraphs_tpu/features/match.py::match_window (with its
// ::hamming_matrix building block).  The JAX version unpacks descriptors
// to 256 floats and runs an all-pairs matmul on the TPU's matrix unit,
// then masks and top-2s the full (Na, Nb) matrix.
//
// What bounds it here: integer ALU work, Na*Nb*8 XOR+popcount pairs
// (4096 x 1000 on the tracking path), with each query's window test in
// front.  Device memory is tiny (Nb descriptors, 32 KB).
//
// Design: one thread per query row; the block stages tiles of the target
// set (descriptors as 8 x uint32, pixels, validity, levels) in shared
// memory and every thread scans them with a fused window/level mask and a
// running best-2 that keeps the lower index on ties (lax.top_k's order).
// No (Na, Nb) matrix exists.  The ratio/max-distance gate follows, and
// duplicate targets are resolved with atomicMin into a (Nb,) claim buffer
// plus a second tiny pass that keeps best <= claimed[nn].  The window test
// uses __fmul_rn/__fadd_rn so it rounds exactly like the plain PyTorch
// version; outputs are integers and agree exactly.
#include "common.cuh"

namespace {

constexpr int TILE = 128;
constexpr int BIG = 10000;

__global__ void match_pass1(const uint32_t* __restrict__ desc_a,
                            const float* __restrict__ uv_a,
                            const uint8_t* __restrict__ valid_a,
                            const int* __restrict__ level_a,
                            const uint32_t* __restrict__ desc_b,
                            const float* __restrict__ uv_b,
                            const uint8_t* __restrict__ valid_b,
                            const int* __restrict__ level_b,
                            int n_a, int n_b, float r2, int level_slack,
                            float ratio, int max_dist,
                            int* __restrict__ match, int* __restrict__ dist,
                            int* __restrict__ claimed) {
    __shared__ uint32_t s_desc[TILE][8];
    __shared__ float s_u[TILE];
    __shared__ float s_v[TILE];
    __shared__ uint8_t s_valid[TILE];
    __shared__ int s_level[TILE];

    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = a < n_a;
    uint32_t da[8];
    float ua = 0.0f, va = 0.0f;
    bool oka = false;
    int la = 0;
    if (active) {
#pragma unroll
        for (int k = 0; k < 8; ++k) da[k] = desc_a[8 * a + k];
        ua = uv_a[2 * a];
        va = uv_a[2 * a + 1];
        oka = valid_a[a] != 0;
        la = level_a != nullptr ? level_a[a] : 0;
    }
    int best = 0x7fffffff;
    int second = 0x7fffffff;
    int best_i = 0;
    for (int t0 = 0; t0 < n_b; t0 += TILE) {
        __syncthreads();
        for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
            const int b = t0 + i;
            if (b < n_b) {
#pragma unroll
                for (int k = 0; k < 8; ++k) s_desc[i][k] = desc_b[8 * b + k];
                s_u[i] = uv_b[2 * b];
                s_v[i] = uv_b[2 * b + 1];
                s_valid[i] = valid_b[b];
                s_level[i] = level_b != nullptr ? level_b[b] : 0;
            }
        }
        __syncthreads();
        if (!active) continue;
        const int n_t = min(TILE, n_b - t0);
        for (int i = 0; i < n_t; ++i) {
            bool m = oka && s_valid[i] != 0;
            if (m) {
                const float du = __fsub_rn(ua, s_u[i]);
                const float dv = __fsub_rn(va, s_v[i]);
                m = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2;
                if (m && level_a != nullptr) {
                    m = abs(la - s_level[i]) <= level_slack;
                }
            }
            int d = BIG;
            if (m) {
                d = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) d += __popc(da[k] ^ s_desc[i][k]);
            }
            if (d < best) {
                second = best;
                best = d;
                best_i = t0 + i;
            } else if (d < second) {
                second = d;
            }
        }
    }
    if (!active) return;
    const bool ok = best <= max_dist &&
                    (float)best <= __fmul_rn(ratio, (float)second);
    match[a] = ok ? best_i : -1;
    dist[a] = best;
    if (ok) atomicMin(&claimed[best_i], best);
}

__global__ void match_pass2(int n_a, const int* __restrict__ claimed,
                            int* __restrict__ match, int* __restrict__ dist) {
    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    if (a >= n_a) return;
    int nn = match[a];
    if (nn >= 0 && dist[a] > claimed[nn]) nn = -1;
    match[a] = nn;
    if (nn < 0) dist[a] = BIG;
}

}  // namespace

// desc_*: (N, 32) u8 viewed as (N, 8) u32; uv_*: (N, 2) f32; valid_*: (N,)
// u8; level_*: (N,) i32 or both NULL (no level band); r2: radius^2 rounded
// to f32; claimed: (n_b,) i32 filled with 10000 by the caller.
// Outputs match (n_a,) i32 (-1 = none) and dist (n_a,) i32 (10000 = none).
VSG_API int vsg_match_window(const uint32_t* desc_a, const float* uv_a,
                             const uint8_t* valid_a, const int* level_a,
                             const uint32_t* desc_b, const float* uv_b,
                             const uint8_t* valid_b, const int* level_b,
                             int n_a, int n_b, float r2, int level_slack,
                             float ratio, int max_dist, int* match,
                             int* dist, int* claimed, cudaStream_t stream) {
    if (n_a == 0) return 0;
    const int threads = 64;
    const int blocks = (n_a + threads - 1) / threads;
    match_pass1<<<blocks, threads, 0, stream>>>(
        desc_a, uv_a, valid_a, level_a, desc_b, uv_b, valid_b, level_b,
        n_a, n_b, r2, level_slack, ratio, max_dist, match, dist, claimed);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    match_pass2<<<blocks, threads, 0, stream>>>(n_a, claimed, match, dist);
    return (int)cudaGetLastError();
}
