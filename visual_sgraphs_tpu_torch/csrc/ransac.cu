// K13: sequential weighted-RANSAC plane extraction.
//
// Replaces visual_sgraphs_tpu/scenegraph/plane_fit.py::ransac_plane and
// ::extract_planes (with core/plane.py::fit_centroid_svd for the refit).
// The JAX version materialises an (H, N) distance matrix per round.
//
// What bounds it here: operations, and barely.  A round scores H = 192
// hypotheses against N = 2,048 points (~9 flops each, 3.5 MFLOP) and
// refits once (four passes over N); the points (24 KB) stay in L1/L2.  At
// these sizes the four dependent rounds are latency-bound.
//
// Design: one launch per round, one block per hypothesis.  A block builds
// its plane from its three sample indices and sums the weights of its
// inliers over all points (nothing of shape (H, N) exists).  The last
// block to finish (a global counter, reset by that block for the next
// round) does the round's epilogue: argmax of the scores with ties going
// to the lowest hypothesis index (jnp.argmax), the weighted centroid and
// 3x3 scatter of the winner's inliers (block reductions), the smallest
// eigenvector by cyclic Jacobi in one thread, the refit plane with its
// sign pinned so the camera origin lies on its positive side (c >= 0),
// the refit inlier mask and score, and the extract-and-remove update of
// the remaining mask and the assignment.  Hypothesis planes and point
// distances use correctly rounded operations in the plain version's
// order, so with unit weights (integer scores) the argmax agrees exactly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

struct Plane {
    float n0, n1, n2, c;
    bool degen;
};

__device__ Plane hypothesis_plane(const float* __restrict__ pts,
                                  const int* __restrict__ idx) {
    const float* p0 = pts + 3 * idx[0];
    const float* p1 = pts + 3 * idx[1];
    const float* p2 = pts + 3 * idx[2];
    const float a0 = __fsub_rn(p1[0], p0[0]), a1 = __fsub_rn(p1[1], p0[1]),
                a2 = __fsub_rn(p1[2], p0[2]);
    const float b0 = __fsub_rn(p2[0], p0[0]), b1 = __fsub_rn(p2[1], p0[1]),
                b2 = __fsub_rn(p2[2], p0[2]);
    float n0 = __fsub_rn(__fmul_rn(a1, b2), __fmul_rn(a2, b1));
    float n1 = __fsub_rn(__fmul_rn(a2, b0), __fmul_rn(a0, b2));
    float n2 = __fsub_rn(__fmul_rn(a0, b1), __fmul_rn(a1, b0));
    const float nn = __fsqrt_rn(dot3_rn(n0, n1, n2, n0, n1, n2));
    Plane pl;
    pl.degen = nn < 1e-8f;
    const float den = fmaxf(nn, 1e-12f);
    n0 = __fdiv_rn(n0, den);
    n1 = __fdiv_rn(n1, den);
    n2 = __fdiv_rn(n2, den);
    pl.n0 = n0;
    pl.n1 = n1;
    pl.n2 = n2;
    pl.c = -dot3_rn(n0, n1, n2, p0[0], p0[1], p0[2]);
    return pl;
}

__device__ __forceinline__ float abs_dist(const Plane& pl,
                                          const float* __restrict__ p) {
    return fabsf(__fadd_rn(dot3_rn(pl.n0, pl.n1, pl.n2, p[0], p[1], p[2]),
                           pl.c));
}

// Sum of NV floats over the block (THREADS threads); every thread gets
// the totals.
template <int NV>
__device__ void block_sum(float (&v)[NV], float (*scratch)[THREADS / 32]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const float s = vsg_warp_sum(v[k]);
        if (lane == 0) scratch[k][warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        float s = 0.0f;
        for (int i = 0; i < THREADS / 32; ++i) s += scratch[k][i];
        v[k] = s;
    }
    __syncthreads();
}

// Eigen-decomposition of a symmetric 3x3 by cyclic Jacobi rotations;
// returns the unit eigenvector of the smallest eigenvalue (the first on
// ties).
__device__ void smallest_eigenvector(float a[3][3], float out[3]) {
    float v[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
    for (int sweep = 0; sweep < 32; ++sweep) {
        const float off = fabsf(a[0][1]) + fabsf(a[0][2]) + fabsf(a[1][2]);
        const float diag = fabsf(a[0][0]) + fabsf(a[1][1]) + fabsf(a[2][2]);
        if (off <= 1e-12f * diag || off == 0.0f) break;
        for (int pq = 0; pq < 3; ++pq) {
            const int p = pq == 2 ? 1 : 0;
            const int q = pq == 0 ? 1 : 2;
            const float apq = a[p][q];
            if (apq == 0.0f) continue;
            const float theta = (a[q][q] - a[p][p]) / (2.0f * apq);
            float t;
            if (fabsf(theta) > 1e18f) {
                t = 0.5f / theta;
            } else {
                t = (theta >= 0.0f ? 1.0f : -1.0f) /
                    (fabsf(theta) + sqrtf(theta * theta + 1.0f));
            }
            const float c = 1.0f / sqrtf(t * t + 1.0f);
            const float s = t * c;
            a[p][p] -= t * apq;
            a[q][q] += t * apq;
            a[p][q] = a[q][p] = 0.0f;
            const int r = 3 - p - q;
            const float arp = a[r][p], arq = a[r][q];
            a[r][p] = a[p][r] = c * arp - s * arq;
            a[r][q] = a[q][r] = s * arp + c * arq;
            for (int i = 0; i < 3; ++i) {
                const float vip = v[i][p], viq = v[i][q];
                v[i][p] = c * vip - s * viq;
                v[i][q] = s * vip + c * viq;
            }
        }
    }
    int k = 0;
    if (a[1][1] < a[k][k]) k = 1;
    if (a[2][2] < a[k][k]) k = 2;
    const float nrm = sqrtf(v[0][k] * v[0][k] + v[1][k] * v[1][k] +
                            v[2][k] * v[2][k]);
    for (int i = 0; i < 3; ++i) out[i] = v[i][k] / fmaxf(nrm, 1e-30f);
}

__global__ void __launch_bounds__(THREADS)
ransac_round(const float* __restrict__ pts, const float* __restrict__ w,
             const int* __restrict__ hyp, int N, int H, float thresh,
             float min_inliers, int round, uint8_t* remaining,
             float* scores, unsigned* counter, float* __restrict__ coeffs_out,
             uint8_t* __restrict__ valid_out, int* __restrict__ assign) {
    __shared__ float scratch[6][THREADS / 32];
    __shared__ float s_val[THREADS];
    __shared__ int s_idx[THREADS];
    __shared__ bool s_last;
    __shared__ float s_plane[4];
    const int tid = threadIdx.x;

    // ---- score this block's hypothesis
    const int* id = hyp + 3 * blockIdx.x;
    const Plane pl = hypothesis_plane(pts, id);
    const bool ok_h = remaining[id[0]] && remaining[id[1]] &&
                      remaining[id[2]] && !pl.degen;
    float sc[1] = {0.0f};
    for (int n = tid; n < N; n += THREADS) {
        if (remaining[n] && abs_dist(pl, pts + 3 * n) < thresh) sc[0] += w[n];
    }
    block_sum<1>(sc, scratch);
    if (tid == 0) {
        scores[blockIdx.x] = ok_h ? sc[0] : -1.0f;
        __threadfence();
        s_last = atomicAdd(counter, 1u) == (unsigned)(H - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();

    // ---- epilogue (the last block): argmax, lowest index on ties
    const volatile float* vs = scores;
    float best_v = -3.0e38f;
    int best_i = 0x7fffffff;
    for (int h = tid; h < H; h += THREADS) {
        const float v = vs[h];
        if (v > best_v) {
            best_v = v;
            best_i = h;
        }
    }
    s_val[tid] = best_v;
    s_idx[tid] = best_i;
    __syncthreads();
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
        if (tid < stride) {
            const float v2 = s_val[tid + stride];
            const int i2 = s_idx[tid + stride];
            if (v2 > s_val[tid] || (v2 == s_val[tid] && i2 < s_idx[tid])) {
                s_val[tid] = v2;
                s_idx[tid] = i2;
            }
        }
        __syncthreads();
    }
    const Plane win = hypothesis_plane(pts, hyp + 3 * s_idx[0]);

    // weighted centroid of the winner's inliers
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = tid; n < N; n += THREADS) {
        const float* p = pts + 3 * n;
        if (remaining[n] && abs_dist(win, p) < thresh) {
            const float wn = w[n];
            cs[0] += wn;
            cs[1] += wn * p[0];
            cs[2] += wn * p[1];
            cs[3] += wn * p[2];
        }
    }
    block_sum<4>(cs, scratch);
    const float wsum = fmaxf(cs[0], 1e-12f);
    const float c0 = cs[1] / wsum, c1 = cs[2] / wsum, c2 = cs[3] / wsum;
    // weighted scatter about it
    float sc6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int n = tid; n < N; n += THREADS) {
        const float* p = pts + 3 * n;
        if (remaining[n] && abs_dist(win, p) < thresh) {
            const float sw = sqrtf(w[n]);
            const float q0 = (p[0] - c0) * sw, q1 = (p[1] - c1) * sw,
                        q2 = (p[2] - c2) * sw;
            sc6[0] += q0 * q0;
            sc6[1] += q0 * q1;
            sc6[2] += q0 * q2;
            sc6[3] += q1 * q1;
            sc6[4] += q1 * q2;
            sc6[5] += q2 * q2;
        }
    }
    block_sum<6>(sc6, scratch);
    if (tid == 0) {
        float a[3][3] = {{sc6[0], sc6[1], sc6[2]},
                         {sc6[1], sc6[3], sc6[4]},
                         {sc6[2], sc6[4], sc6[5]}};
        float n[3];
        smallest_eigenvector(a, n);
        float c = -(n[0] * c0 + n[1] * c1 + n[2] * c2);
        const float nrm = fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]),
                                1.17549435e-38f);
        const float sgn = (c / nrm) < 0.0f ? -1.0f : 1.0f;
        s_plane[0] = sgn * n[0] / nrm;
        s_plane[1] = sgn * n[1] / nrm;
        s_plane[2] = sgn * n[2] / nrm;
        s_plane[3] = sgn * c / nrm;
    }
    __syncthreads();
    Plane ref;
    ref.n0 = s_plane[0];
    ref.n1 = s_plane[1];
    ref.n2 = s_plane[2];
    ref.c = s_plane[3];
    ref.degen = false;

    // refit inlier score
    float sr[1] = {0.0f};
    for (int n = tid; n < N; n += THREADS) {
        if (remaining[n] && abs_dist(ref, pts + 3 * n) < thresh) sr[0] += w[n];
    }
    block_sum<1>(sr, scratch);
    const bool good = sr[0] >= min_inliers;
    if (tid == 0) {
        for (int k = 0; k < 4; ++k) coeffs_out[4 * round + k] =
            good ? s_plane[k] : 0.0f;
        valid_out[round] = good ? 1 : 0;
        *counter = 0u;
    }
    if (!good) return;
    // extract and remove (each thread revisits its own points)
    for (int n = tid; n < N; n += THREADS) {
        if (remaining[n] && abs_dist(ref, pts + 3 * n) < thresh) {
            assign[n] = round;
            remaining[n] = 0;
        }
    }
}

}  // namespace

// points (N, 3) f32, valid (N,) u8, weights (N,) f32, hyp (P, H, 3) i32
// sample indices.  Outputs coeffs (P, 4) f32 (0 where not found),
// pvalid (P,) u8, assign (N,) i32 (-1 = none).  Scratch: remaining (N,)
// u8, scores (H,) f32, counter (1,) u32.  P launches of H blocks each.
VSG_API int vsg_extract_planes(const float* pts, const uint8_t* valid,
                               const float* w, const int* hyp, int N,
                               int n_planes, int n_hyp, float thresh,
                               float min_inliers, float* coeffs,
                               uint8_t* pvalid, int* assign,
                               uint8_t* remaining, float* scores,
                               unsigned* counter, cudaStream_t stream) {
    cudaError_t err = cudaMemcpyAsync(remaining, valid, N, cudaMemcpyDeviceToDevice,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(assign, 0xff, sizeof(int) * N, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < n_planes; ++i) {
        ransac_round<<<n_hyp, THREADS, 0, stream>>>(
            pts, w, hyp + 3 * n_hyp * i, N, n_hyp, thresh, min_inliers, i,
            remaining, scores, counter, coeffs, pvalid, assign);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
