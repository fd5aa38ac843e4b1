// K13: sequential weighted-RANSAC plane extraction, one launch a detection.
//
// Replaces visual_sgraphs_tpu/scenegraph/plane_fit.py::ransac_plane and
// ::extract_planes (with core/plane.py::fit_centroid_svd for the refit).
// The JAX version materialises an (H, N) distance matrix per round.
//
// What bounds it here: operations, and barely.  A round scores H = 192
// hypotheses against N = 2,048 points (~9 flops each, 3.5 MFLOP) and
// refits once (four passes over N); the points (24 KB) fit in shared
// memory.  At these sizes the four dependent rounds are latency-bound.
//
// Design: one launch of one cluster of C CTAs (16 when a cluster of 16
// fits on the card, else the portable 8) runs every round in order.  Each
// CTA holds the cloud in its shared memory (x, y, z and the weight while
// the point remains, 0 once removed, as a float4; the remaining mask as
// bytes) and every round's samples.  A round:
// 1. each CTA scores its share of the hypotheses (ceil(H / C) in a row),
//    two warps for two hypotheses (the point shares of sum trees 0-3 and
//    4-7 below, each point read once for both): each one's plane from its
//    three sample indices, and the summed weights of its remaining inliers
//    (nothing of shape (H, N) exists);
//    each CTA publishes its best (score, index), ties to the lowest index
//    (jnp.argmax);
// 2. after a cluster barrier CTA 0 reads the C bests from distributed
//    shared memory (a lane a CTA) and refits the winner alone: the
//    weighted centroid, 3x3 scatter and refit inlier score of the
//    winner's inliers, each summed by its warps 0-7 (a lane a strided
//    share of the points) and added in warp order, between them the
//    smallest eigenvector by cyclic Jacobi in one thread and the sign
//    pinned so the camera origin lies on the plane's positive side
//    (c >= 0);
// 3. after a second cluster barrier every CTA reads the plane and whether
//    it was found, and applies the extract-and-remove update to its own
//    copy of the cloud (each assignment written by one CTA).
// Two cluster barriers a round and one at the end; no global counter,
// fence hand-off, copy or memset.  (A first form reduced the refit sums
// across CTAs 0-7 behind four cluster barriers a round: the barriers and
// the serial reads of the partials cost more than the passes.)  Every sum
// keeps the order of the former one-block-per-hypothesis kernel (256
// threads, each over the points t, t + 256, ..., a shuffle tree a warp,
// the 8 warps in order): a lane sums the shares of eight of those threads
// and the shuffle trees run as they did, so the outputs are bitwise those
// of that kernel, and bitwise equal from launch to launch.  Hypothesis
// planes and point distances use correctly rounded operations in the
// plain version's order, so with unit weights (integer scores) the argmax
// agrees with the twin's exactly.
#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
// the summation order's threads: a point n belongs to share n % PT, the
// shares of PT / 32 consecutive threads to one shuffle tree
constexpr int PT = 256;
constexpr int TREES = PT / 32;

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                     __fmul_rn(a2, b2));
}

struct Plane {
    float n0, n1, n2, c;
    bool degen;
};

__device__ Plane hypothesis_plane(const float4* __restrict__ pts,
                                  const int* __restrict__ idx) {
    const float4 p0 = pts[idx[0]], p1 = pts[idx[1]], p2 = pts[idx[2]];
    const float a0 = __fsub_rn(p1.x, p0.x), a1 = __fsub_rn(p1.y, p0.y),
                a2 = __fsub_rn(p1.z, p0.z);
    const float b0 = __fsub_rn(p2.x, p0.x), b1 = __fsub_rn(p2.y, p0.y),
                b2 = __fsub_rn(p2.z, p0.z);
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
    pl.c = -dot3_rn(n0, n1, n2, p0.x, p0.y, p0.z);
    return pl;
}

__device__ __forceinline__ float abs_dist(const Plane& pl, float4 p) {
    return fabsf(__fadd_rn(dot3_rn(pl.n0, pl.n1, pl.n2, p.x, p.y, p.z),
                           pl.c));
}

// (v, i) beats (bv, bi): larger score, the lower index on ties
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
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

// The sum of the trees' partials in order (the former block_sum's
// ``s = 0; s += scratch[k][i]``).
__device__ __forceinline__ float tree_total(const float* part, int stride,
                                            int k) {
    float s = 0.0f;
    for (int t = 0; t < TREES; ++t) s += part[t * stride + k];
    return s;
}

// C: the cluster's CTAs (the launch sets the same cluster dimension)
template <int C>
__global__ void __launch_bounds__(THREADS)
extract_planes_kernel(const float* __restrict__ pts,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ w,
                      const int* __restrict__ hyp, int N, int n_planes,
                      int H, float thresh, float min_inliers,
                      float* __restrict__ coeffs_out,
                      uint8_t* __restrict__ valid_out,
                      int* __restrict__ assign) {
    // (N,): x, y, z, weight (0: removed); the samples of every round
    // (n_planes, H, 3); the remaining mask (N,)
    extern __shared__ float4 s_pt[];
    int* s_hyp = reinterpret_cast<int*>(s_pt + N);
    uint8_t* s_rem = reinterpret_cast<uint8_t*>(s_hyp + 3 * H * n_planes);
    // a pass's hypotheses: the trees' sums, the samples' validity, scores
    __shared__ float s_tree[WARPS][TREES], s_score[WARPS];
    __shared__ bool s_ok[WARPS];
    // published to the cluster: each CTA's best (score, index); CTA 0's
    // refit plane and whether it was found
    __shared__ float s_bv;
    __shared__ int s_bi;
    __shared__ float s_ref[5];
    // CTA 0: the winner, the trees' partials, the centroid
    __shared__ int s_win;
    __shared__ float s_cpart[TREES][4], s_spart[TREES][6], s_rpart[TREES];
    __shared__ float s_plane[5];
    cg::cluster_group cl = cg::this_cluster();
    const int c = (int)cl.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int half = warp & 1;
    // this CTA's assignments and hypotheses
    const int per_pt = (N + C - 1) / C, n0 = c * per_pt;
    const int n1 = min(N, n0 + per_pt);
    const int per_h = (H + C - 1) / C, h0 = c * per_h;
    const int h1 = min(H, h0 + per_h);
    for (int n = tid; n < N; n += THREADS) {
        const bool ok = valid[n] != 0;
        s_pt[n] = make_float4(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2],
                              ok ? w[n] : 0.0f);
        s_rem[n] = ok;
    }
    for (int k = tid; k < 3 * H * n_planes; k += THREADS) s_hyp[k] = hyp[k];
    for (int n = n0 + tid; n < n1; n += THREADS) assign[n] = -1;
    __syncthreads();
    // the refit passes: warp t of CTA 0 sums tree t (the former threads
    // 32 t .. 32 t + 31)
    const bool summer = warp < TREES;
    const int t0 = 32 * warp + lane;

    for (int round = 0; round < n_planes; ++round) {
        const int* hr = s_hyp + 3 * H * round;
        // ---- 1. score this CTA's hypotheses: two warps for two of them
        // (trees 0-3 and 4-7 of both, each point read once for both), up
        // to WARPS at once
        float bv = -3.0e38f;
        int bi = INT_MAX;
        for (int pass = h0; pass < h1; pass += WARPS) {
            const int j = 2 * (warp >> 1), ha = pass + j;
            if (ha < h1) {
                const int *ia = hr + 3 * ha, *ib = hr + 3 * min(ha + 1, h1 - 1);
                const Plane pa = hypothesis_plane(s_pt, ia);
                const Plane pb = hypothesis_plane(s_pt, ib);
#pragma unroll
                for (int tt = 0; tt < TREES / 2; ++tt) {
                    const int tree = half * (TREES / 2) + tt;
                    float va = 0.0f, vb = 0.0f;
                    for (int n = 32 * tree + lane; n < N; n += PT) {
                        const float4 p = s_pt[n];
                        if (abs_dist(pa, p) < thresh) va += p.w;
                        if (abs_dist(pb, p) < thresh) vb += p.w;
                    }
                    va = vsg_warp_sum(va);
                    vb = vsg_warp_sum(vb);
                    if (lane == 0) {
                        s_tree[j][tree] = va;
                        s_tree[j + 1][tree] = vb;
                    }
                }
                if (half == 0 && lane == 0) {
                    s_ok[j] = s_rem[ia[0]] && s_rem[ia[1]] && s_rem[ia[2]] &&
                              !pa.degen;
                    s_ok[j + 1] = s_rem[ib[0]] && s_rem[ib[1]] &&
                                  s_rem[ib[2]] && !pb.degen;
                }
            }
            __syncthreads();
            // each score: the trees in order from 0, as the former block_sum
            if (tid < WARPS && pass + tid < h1) {
                float sc = 0.0f;
                for (int t = 0; t < TREES; ++t) sc += s_tree[tid][t];
                s_score[tid] = s_ok[tid] ? sc : -1.0f;
            }
            __syncthreads();
            if (tid == 0) {
                for (int k = 0; k < WARPS && pass + k < h1; ++k) {
                    if (better(s_score[k], pass + k, bv, bi)) {
                        bv = s_score[k];
                        bi = pass + k;
                    }
                }
            }
            __syncthreads();
        }
        if (tid == 0) {
            s_bv = bv;
            s_bi = bi;
        }
        cl.sync();
        // ---- 2. CTA 0: the winner, its refit, the refit's score
        if (c == 0) {
            if (warp == 0) {
                float v = -3.0e38f;
                int i = INT_MAX;
                if (lane < C) {
                    v = *cl.map_shared_rank(&s_bv, lane);
                    i = *cl.map_shared_rank(&s_bi, lane);
                }
                for (int off = 16; off > 0; off >>= 1) {
                    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
                    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
                    if (better(ov, oi, v, i)) {
                        v = ov;
                        i = oi;
                    }
                }
                if (lane == 0) s_win = i == INT_MAX ? 0 : i;
            }
            __syncthreads();
            const Plane win = hypothesis_plane(s_pt, hr + 3 * s_win);
            // weighted centroid of the winner's inliers
            if (summer) {
                float cs[4] = {0.f, 0.f, 0.f, 0.f};
                for (int n = t0; n < N; n += PT) {
                    const float4 p = s_pt[n];
                    if (s_rem[n] && abs_dist(win, p) < thresh) {
                        const float wn = p.w;
                        cs[0] += wn;
                        cs[1] += wn * p.x;
                        cs[2] += wn * p.y;
                        cs[3] += wn * p.z;
                    }
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float s = vsg_warp_sum(cs[k]);
                    if (lane == 0) s_cpart[warp][k] = s;
                }
            }
            __syncthreads();
            const float wsum = fmaxf(tree_total(&s_cpart[0][0], 4, 0),
                                     1e-12f);
            const float c0 = tree_total(&s_cpart[0][0], 4, 1) / wsum,
                        c1 = tree_total(&s_cpart[0][0], 4, 2) / wsum,
                        c2 = tree_total(&s_cpart[0][0], 4, 3) / wsum;
            // weighted scatter about it
            if (summer) {
                float sc6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int n = t0; n < N; n += PT) {
                    const float4 p = s_pt[n];
                    if (s_rem[n] && abs_dist(win, p) < thresh) {
                        const float sw = sqrtf(p.w);
                        const float q0 = (p.x - c0) * sw,
                                    q1 = (p.y - c1) * sw,
                                    q2 = (p.z - c2) * sw;
                        sc6[0] += q0 * q0;
                        sc6[1] += q0 * q1;
                        sc6[2] += q0 * q2;
                        sc6[3] += q1 * q1;
                        sc6[4] += q1 * q2;
                        sc6[5] += q2 * q2;
                    }
                }
#pragma unroll
                for (int k = 0; k < 6; ++k) {
                    const float s = vsg_warp_sum(sc6[k]);
                    if (lane == 0) s_spart[warp][k] = s;
                }
            }
            __syncthreads();
            if (tid == 0) {
                float sc6[6];
                for (int k = 0; k < 6; ++k) {
                    sc6[k] = tree_total(&s_spart[0][0], 6, k);
                }
                float a[3][3] = {{sc6[0], sc6[1], sc6[2]},
                                 {sc6[1], sc6[3], sc6[4]},
                                 {sc6[2], sc6[4], sc6[5]}};
                float n[3];
                smallest_eigenvector(a, n);
                float cc = -(n[0] * c0 + n[1] * c1 + n[2] * c2);
                const float nrm = fmaxf(
                    sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]),
                    1.17549435e-38f);
                const float sgn = (cc / nrm) < 0.0f ? -1.0f : 1.0f;
                s_plane[0] = sgn * n[0] / nrm;
                s_plane[1] = sgn * n[1] / nrm;
                s_plane[2] = sgn * n[2] / nrm;
                s_plane[3] = sgn * cc / nrm;
            }
            __syncthreads();
            // refit inlier score
            if (summer) {
                Plane ref;
                ref.n0 = s_plane[0];
                ref.n1 = s_plane[1];
                ref.n2 = s_plane[2];
                ref.c = s_plane[3];
                float sr = 0.0f;
                for (int n = t0; n < N; n += PT) {
                    const float4 p = s_pt[n];
                    if (s_rem[n] && abs_dist(ref, p) < thresh) sr += p.w;
                }
                const float s = vsg_warp_sum(sr);
                if (lane == 0) s_rpart[warp] = s;
            }
            __syncthreads();
            if (tid == 0) {
                const bool good = tree_total(s_rpart, 1, 0) >= min_inliers;
                for (int k = 0; k < 4; ++k) {
                    coeffs_out[4 * round + k] = good ? s_plane[k] : 0.0f;
                }
                valid_out[round] = good ? 1 : 0;
                s_plane[4] = good ? 1.0f : 0.0f;
            }
        }
        cl.sync();
        // ---- 3. extract and remove, in every CTA's copy
        if (tid < 5) s_ref[tid] = *cl.map_shared_rank(&s_plane[tid], 0);
        __syncthreads();
        if (s_ref[4] != 0.0f) {
            Plane ref;
            ref.n0 = s_ref[0];
            ref.n1 = s_ref[1];
            ref.n2 = s_ref[2];
            ref.c = s_ref[3];
            for (int n = tid; n < N; n += THREADS) {
                float4 p = s_pt[n];
                if (s_rem[n] && abs_dist(ref, p) < thresh) {
                    if (n >= n0 && n < n1) assign[n] = round;
                    s_rem[n] = 0;
                    p.w = 0.0f;
                    s_pt[n] = p;
                }
            }
        }
        __syncthreads();
    }
    // no CTA leaves while another may read its shared memory
    cl.sync();
}

template <int C>
cudaError_t launch(size_t smem, cudaStream_t stream, const float* pts,
                   const uint8_t* valid, const float* w, const int* hyp,
                   int N, int n_planes, int H, float thresh,
                   float min_inliers, float* coeffs, uint8_t* pvalid,
                   int* assign) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, extract_planes_kernel<C>, pts, valid, w,
                              hyp, N, n_planes, H, thresh, min_inliers,
                              coeffs, pvalid, assign);
}

}  // namespace

// points (N, 3) f32, valid (N,) u8, weights (N,) f32, hyp (P, H, 3) i32
// sample indices.  Outputs coeffs (P, 4) f32 (0 where not found),
// pvalid (P,) u8, assign (N,) i32 (-1 = none).  One launch.
VSG_API int vsg_extract_planes(const float* pts, const uint8_t* valid,
                               const float* w, const int* hyp, int N,
                               int n_planes, int n_hyp, float thresh,
                               float min_inliers, float* coeffs,
                               uint8_t* pvalid, int* assign,
                               cudaStream_t stream) {
    if (N == 0 && n_planes == 0) return 0;
    const size_t smem = sizeof(float4) * (size_t)N +
                        sizeof(int) * 3 * (size_t)n_hyp * n_planes + N;
    if (smem > 232448 - 1024) return (int)cudaErrorInvalidValue;
    // 16 CTAs when a cluster of 16 fits on the card, else the portable 8
    // (queried once per shared size)
    static size_t queried = (size_t)-1;
    static int cluster = 8;
    cudaError_t err;
    if (queried != smem) {
        err = cudaFuncSetAttribute(extract_planes_kernel<16>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                extract_planes_kernel<16>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        }
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(
                extract_planes_kernel<8>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        }
        if (err != cudaSuccess) return (int)err;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(16, 1, 1);
        cfg.blockDim = dim3(THREADS, 1, 1);
        cfg.dynamicSmemBytes = smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 16;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int fit16 = 0;
        err = cudaOccupancyMaxActiveClusters(&fit16,
                                             extract_planes_kernel<16>, &cfg);
        if (err != cudaSuccess) return (int)err;
        cluster = fit16 >= 1 ? 16 : 8;
        queried = smem;
    }
    err = cluster == 16
              ? launch<16>(smem, stream, pts, valid, w, hyp, N, n_planes,
                           n_hyp, thresh, min_inliers, coeffs, pvalid, assign)
              : launch<8>(smem, stream, pts, valid, w, hyp, N, n_planes,
                          n_hyp, thresh, min_inliers, coeffs, pvalid, assign);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
