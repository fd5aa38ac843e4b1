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

// ---- NN ratio (SearchByBoW) -------------------------------------------
//
// Replaces features/match.py::match_nn_ratio with ::_rotation_consistency
// (loop verification and relocalisation: 1000 x 1000 keyframe
// descriptors).  The JAX version top-2s the full (Na, Nb) Hamming matrix,
// argmins its transpose for the mutual check and scatters a 30-bin
// histogram.  Bound: integer operations (Na*Nb XOR+popcount pairs, twice:
// once by rows, once by columns).  Design: one launch whose first blocks
// scan rows (running best-2, lower index on ties) and whose last blocks
// scan columns (first best row), each staging the other side's
// descriptors in shared memory; no (Na, Nb) matrix exists.  A second
// launch, one block, applies the gates, the mutual check and the rotation
// histogram (shared-memory atomics, the third-largest count by one
// thread) and writes the outputs.  Integers throughout: exact.
constexpr float TWO_PI_F = 6.28318548202514648f;  // float32(2 pi)
constexpr int HISTO = 30;

__global__ void nn_scan(const uint32_t* __restrict__ desc_a,
                        const uint8_t* __restrict__ valid_a,
                        const uint32_t* __restrict__ desc_b,
                        const uint8_t* __restrict__ valid_b, int n_a,
                        int n_b, int row_blocks, int* __restrict__ nn,
                        int* __restrict__ best, int* __restrict__ second,
                        int* __restrict__ back) {
    __shared__ uint32_t s_desc[TILE][8];
    __shared__ uint8_t s_valid[TILE];
    const bool rows = (int)blockIdx.x < row_blocks;
    // rows: query = a, targets = b; columns: query = b, targets = a
    const uint32_t* qd = rows ? desc_a : desc_b;
    const uint8_t* qv = rows ? valid_a : valid_b;
    const uint32_t* td = rows ? desc_b : desc_a;
    const uint8_t* tv = rows ? valid_b : valid_a;
    const int n_q = rows ? n_a : n_b;
    const int n_t = rows ? n_b : n_a;
    const int q = (rows ? blockIdx.x : blockIdx.x - row_blocks) * blockDim.x
                  + threadIdx.x;
    const bool active = q < n_q;
    uint32_t dq[8];
    bool okq = false;
    if (active) {
#pragma unroll
        for (int k = 0; k < 8; ++k) dq[k] = qd[8 * q + k];
        okq = qv[q] != 0;
    }
    int b1 = 0x7fffffff, b2 = 0x7fffffff, b1_i = 0;
    for (int t0 = 0; t0 < n_t; t0 += TILE) {
        __syncthreads();
        for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
            const int t = t0 + i;
            if (t < n_t) {
#pragma unroll
                for (int k = 0; k < 8; ++k) s_desc[i][k] = td[8 * t + k];
                s_valid[i] = tv[t];
            }
        }
        __syncthreads();
        if (!active) continue;
        const int cnt = min(TILE, n_t - t0);
        for (int i = 0; i < cnt; ++i) {
            int d = BIG;
            if (okq && s_valid[i] != 0) {
                d = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) d += __popc(dq[k] ^ s_desc[i][k]);
            }
            if (d < b1) {
                b2 = b1;
                b1 = d;
                b1_i = t0 + i;
            } else if (d < b2) {
                b2 = d;
            }
        }
    }
    if (!active) return;
    if (rows) {
        nn[q] = b1_i;
        best[q] = b1;
        second[q] = b2;
    } else {
        back[q] = b1_i;
    }
}

__global__ void nn_finish(const int* __restrict__ nn,
                          const int* __restrict__ best,
                          const int* __restrict__ second,
                          const int* __restrict__ back,
                          const uint8_t* __restrict__ valid_a,
                          const float* __restrict__ angle_a,
                          const float* __restrict__ angle_b, int n_a,
                          float ratio, int max_dist, int mutual,
                          int* __restrict__ match, int* __restrict__ dist) {
    __shared__ int counts[HISTO];
    __shared__ int thresh;
    for (int i = threadIdx.x; i < HISTO; i += blockDim.x) counts[i] = 0;
    __syncthreads();
    for (int a = threadIdx.x; a < n_a; a += blockDim.x) {
        const int j = nn[a];
        bool ok = best[a] <= max_dist &&
                  (float)best[a] <= __fmul_rn(ratio, (float)second[a]) &&
                  valid_a[a] != 0;
        if (mutual) ok = ok && back[j] == a;
        match[a] = ok ? 1 : 0;
        if (angle_a != nullptr) {
            const float da = __fsub_rn(angle_a[a], angle_b[j]);
            float m = fmodf(da, TWO_PI_F);
            if (m != 0.0f && m < 0.0f) m = __fadd_rn(m, TWO_PI_F);
            const int bin =
                ((int)floorf(__fmul_rn(__fdiv_rn(m, TWO_PI_F), (float)HISTO)))
                % HISTO;
            dist[a] = bin;  // the bin, until the final pass
            if (ok) atomicAdd(&counts[bin], 1);
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int c1 = -1, c2 = -1, c3 = -1;
        for (int i = 0; i < HISTO; ++i) {
            const int c = counts[i];
            if (c > c1) {
                c3 = c2;
                c2 = c1;
                c1 = c;
            } else if (c > c2) {
                c3 = c2;
                c2 = c;
            } else if (c > c3) {
                c3 = c;
            }
        }
        thresh = max(c3, 1);
    }
    __syncthreads();
    for (int a = threadIdx.x; a < n_a; a += blockDim.x) {
        bool ok = match[a] != 0;
        if (angle_a != nullptr) ok = ok && counts[dist[a]] >= thresh;
        match[a] = ok ? nn[a] : -1;
        dist[a] = ok ? best[a] : BIG;
    }
}

// ---- guided re-match count (K16) ----------------------------------------
//
// Replaces the guided count of place/loop_closer.py::_loop_geometry
// (:86-100), which builds (F, F) squared-distance and Hamming matrices
// and reduces an any-per-row.  Bound: integer operations, F x F window
// tests and (for pairs in the window) XOR+popcounts.  Design: one thread
// per row of ``a``; the block stages ``b``'s pixels, validity and
// descriptors in shared memory; a row stops scanning at its first hit and
// adds one to the count with an integer atomic (exact).  The window test
// uses correctly rounded operations in the plain version's order.
__global__ void guided_count_kernel(const float* __restrict__ uv_a,
                                    const uint8_t* __restrict__ valid_a,
                                    const uint32_t* __restrict__ desc_a,
                                    const float* __restrict__ uv_b,
                                    const uint8_t* __restrict__ valid_b,
                                    const uint32_t* __restrict__ desc_b,
                                    int n_a, int n_b, float r2, int max_hd,
                                    int* __restrict__ count) {
    __shared__ uint32_t s_desc[TILE][8];
    __shared__ float s_u[TILE];
    __shared__ float s_v[TILE];
    __shared__ uint8_t s_valid[TILE];
    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = a < n_a && valid_a[a] != 0;
    uint32_t da[8];
    float ua = 0.0f, va = 0.0f;
    if (active) {
#pragma unroll
        for (int k = 0; k < 8; ++k) da[k] = desc_a[8 * a + k];
        ua = uv_a[2 * a];
        va = uv_a[2 * a + 1];
    }
    bool hit = false;
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
            }
        }
        __syncthreads();
        if (!active || hit) continue;
        const int cnt = min(TILE, n_b - t0);
        for (int i = 0; i < cnt && !hit; ++i) {
            if (s_valid[i] == 0) continue;
            const float du = __fsub_rn(ua, s_u[i]);
            const float dv = __fsub_rn(va, s_v[i]);
            if (!(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < r2)) {
                continue;
            }
            int d = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) d += __popc(da[k] ^ s_desc[i][k]);
            hit = d <= max_hd;
        }
    }
    if (hit) atomicAdd(count, 1);
}

}  // namespace

// desc_*: (N, 32) u8 as (N, 8) u32; valid_*: (N,) u8; angle_*: (N,) f32 or
// both NULL (no rotation histogram); scratch: (3 n_a + n_b) i32.  Outputs
// match (n_a,) i32 (-1 = none), dist (n_a,) i32 (10000 = none).
VSG_API int vsg_match_nn_ratio(const uint32_t* desc_a, const uint8_t* valid_a,
                               const uint32_t* desc_b, const uint8_t* valid_b,
                               const float* angle_a, const float* angle_b,
                               int n_a, int n_b, float ratio, int max_dist,
                               int mutual, int* scratch, int* match,
                               int* dist, cudaStream_t stream) {
    if (n_a == 0) return 0;
    const int threads = 64;
    const int row_blocks = (n_a + threads - 1) / threads;
    const int col_blocks = (n_b + threads - 1) / threads;
    int* nn = scratch;
    int* best = scratch + n_a;
    int* second = scratch + 2 * n_a;
    int* back = scratch + 3 * n_a;
    nn_scan<<<row_blocks + col_blocks, threads, 0, stream>>>(
        desc_a, valid_a, desc_b, valid_b, n_a, n_b, row_blocks, nn, best,
        second, back);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nn_finish<<<1, 1024, 0, stream>>>(nn, best, second, back, valid_a,
                                      angle_a, angle_b, n_a, ratio, max_dist,
                                      mutual, match, dist);
    return (int)cudaGetLastError();
}

// uv_a: (n_a, 2) f32 projections, uv_b: (n_b, 2) f32 keypoints; r2: the
// squared radius rounded to f32; count: 0-d i32 zero-filled by the caller.
VSG_API int vsg_guided_count(const float* uv_a, const uint8_t* valid_a,
                             const uint32_t* desc_a, const float* uv_b,
                             const uint8_t* valid_b, const uint32_t* desc_b,
                             int n_a, int n_b, float r2, int max_hd,
                             int* count, cudaStream_t stream) {
    if (n_a == 0) return 0;
    const int threads = 128;
    guided_count_kernel<<<(n_a + threads - 1) / threads, threads, 0,
                          stream>>>(uv_a, valid_a, desc_a, uv_b, valid_b,
                                    desc_b, n_a, n_b, r2, max_hd, count);
    return (int)cudaGetLastError();
}

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
