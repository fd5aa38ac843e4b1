// K15: Sim3 RANSAC + refinement (loop verification) and PnP RANSAC
// (relocalisation).
//
// Sim3 half.  Replaces visual_sgraphs_tpu/place/sim3_ransac.py::ransac_sim3
// and ::refine_sim3 as place/loop_closer.py::_loop_geometry chains them.
// The JAX version vmaps a Horn solve (a batched 3x3 SVD) over 256
// hypotheses, builds an (H, M, 3) prediction tensor to count inliers, and
// refines with jacfwd + a 7x7 solve per Gauss-Newton step.  Bound:
// operations, H x M transformed points (256 x 1000, ~30 flops each) plus
// five refinement passes over M; the points (24 KB) stay in L1.
// Design, two launches: (1) one block per hypothesis, whose first thread
// solves Horn on its three pairs (the 3x3 cross-covariance, the SVD
// through a cyclic-Jacobi eigensolve of W^T W in double, the determinant
// fix and the scale as trace(R^T W) / var) and whose threads then count
// the inliers over all points; (2) one block that takes the first best
// hypothesis, recomputes its inlier mask with the same arithmetic, runs
// the weighted Horn polish with the reference's w_best + 1e-9 weights on
// every row (invalid rows included) and its keep-if-no-loss rule, then
// the five refinement steps with the analytic Jacobian [I, -[y]x, y]
// (block reductions of the 28 + 7 normal-equation sums, the 7x7 solve in
// one thread) and the final inlier mask.
//
// PnP half.  Replaces visual_sgraphs_tpu/place/pnp.py::_dlt_pose and the
// hypothesis part of ::ransac_pnp (its GN refinement is K6).  The JAX
// version solves a batched (H, 12, 12) eigh and an (H, M) projection.
// Bound: operations, the 12x12 eigensolves (192 of them) and H x M
// projections.  Design, two launches: (1) one block per hypothesis, whose
// first thread builds A^T A (12x12, summed in double), takes the smallest
// eigenvector by cyclic Jacobi, applies the depth-sign fix, the 3x3
// procrustes and scale = mean(S), and whose threads count the
// reprojection inliers (non-finite poses score -1); (2) one thread picks
// the first best pose (identity if it is not finite).
#include "lie.cuh"

namespace {

constexpr int BT = 256;  // threads of a hypothesis block
constexpr int FT = 256;  // threads of the finishing block

__device__ int block_sum_i(int v, int* scratch) {
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += scratch[i];
    __syncthreads();
    return s;
}

// Sum of NV floats over the block; every thread gets the totals.
template <int NV>
__device__ void block_sums(float (&v)[NV], float (*scratch)[32]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const float s = vsg_warp_sum(v[k]);
        if (lane == 0) scratch[k][warp] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        float s = 0.0f;
        for (int i = 0; i < nw; ++i) s += scratch[k][i];
        v[k] = s;
    }
    __syncthreads();
}

// Horn's closed form from normalised weights' sums: mu_s, mu_d, the
// cross-covariance W_ij = sum w dc_i sc_j and var_s = sum w |sc|^2.
__device__ void horn_close(const float* mu_s, const float* mu_d,
                           const float W[3][3], float var_s, bool fix_scale,
                           float* S) {
    float R[3][3], sv[3];
    procrustes(W, R, sv);
    float s = 1.0f;
    if (!fix_scale) {
        float tr = 0.0f;
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) tr += R[i][j] * W[i][j];
        }
        s = tr / fmaxf(var_s, 1e-12f);
    }
    matrix_to_quat(R, S);
    for (int i = 0; i < 3; ++i) {
        S[4 + i] = mu_d[i] - s * (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] +
                                  R[i][2] * mu_s[2]);
    }
    S[7] = s;
}

__device__ __forceinline__ bool is_inlier(const float* S, const float* pa,
                                          const float* pb, bool valid,
                                          float thresh) {
    float y[3];
    sim3_apply(S, pa, y);
    const float d0 = y[0] - pb[0], d1 = y[1] - pb[1], d2 = y[2] - pb[2];
    return valid && sqrtf(d0 * d0 + d1 * d1 + d2 * d2) < thresh;
}

__global__ void __launch_bounds__(BT)
    sim3_hyp_kernel(const float* __restrict__ p_a,
                    const float* __restrict__ p_b,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ samples, int M, float thresh,
                    int fix_scale, float* __restrict__ S_hyp,
                    int* __restrict__ counts) {
    __shared__ float S[8];
    __shared__ int scratch[32];
    const int h = blockIdx.x;
    if (threadIdx.x == 0) {
        float src[3][3], dst[3][3];
        for (int k = 0; k < 3; ++k) {
            const int i = samples[3 * h + k];
            for (int c = 0; c < 3; ++c) {
                src[k][c] = p_a[3 * i + c];
                dst[k][c] = p_b[3 * i + c];
            }
        }
        const float w = 1.0f / 3.0f;
        float mu_s[3], mu_d[3];
        for (int c = 0; c < 3; ++c) {
            mu_s[c] = w * (src[0][c] + src[1][c] + src[2][c]);
            mu_d[c] = w * (dst[0][c] + dst[1][c] + dst[2][c]);
        }
        float W[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
        float var_s = 0.0f;
        for (int k = 0; k < 3; ++k) {
            float sc[3], dc[3];
            for (int c = 0; c < 3; ++c) {
                sc[c] = src[k][c] - mu_s[c];
                dc[c] = dst[k][c] - mu_d[c];
            }
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 3; ++j) W[i][j] += w * dc[i] * sc[j];
            }
            var_s += w * (sc[0] * sc[0] + sc[1] * sc[1] + sc[2] * sc[2]);
        }
        horn_close(mu_s, mu_d, W, var_s, fix_scale != 0, S);
    }
    __syncthreads();
    int c = 0;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        c += is_inlier(S, p_a + 3 * m, p_b + 3 * m, valid[m] != 0, thresh);
    }
    c = block_sum_i(c, scratch);
    if (threadIdx.x == 0) {
        counts[h] = c;
        for (int k = 0; k < 8; ++k) S_hyp[8 * h + k] = S[k];
    }
}

__global__ void __launch_bounds__(FT)
    sim3_finish_kernel(const float* __restrict__ p_a,
                       const float* __restrict__ p_b,
                       const uint8_t* __restrict__ valid, int M, int H,
                       float thresh, int fix_scale, int iters,
                       const float* __restrict__ S_hyp,
                       const int* __restrict__ counts,
                       float* __restrict__ S_out, int* __restrict__ n_out,
                       uint8_t* __restrict__ inl_out) {
    __shared__ float Sb[8];
    __shared__ float Sr[8];
    __shared__ float fscratch[35][32];
    __shared__ int scratch[32];
    __shared__ int best_count;
    if (threadIdx.x == 0) {
        int b = 0;
        for (int h = 1; h < H; ++h) {
            if (counts[h] > counts[b]) b = h;
        }
        best_count = counts[b];
        for (int k = 0; k < 8; ++k) Sb[k] = S_hyp[8 * b + k];
    }
    __syncthreads();

    // weighted Horn polish on the winner's inliers (weights w + 1e-9)
    float s1[7];
    for (int k = 0; k < 7; ++k) s1[k] = 0.0f;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const float w = (is_inlier(Sb, p_a + 3 * m, p_b + 3 * m,
                                   valid[m] != 0, thresh) ? 1.0f : 0.0f)
                        + 1e-9f;
        s1[0] += w;
        for (int c = 0; c < 3; ++c) {
            s1[1 + c] += w * p_a[3 * m + c];
            s1[4 + c] += w * p_b[3 * m + c];
        }
    }
    block_sums<7>(s1, fscratch);
    const float wsum = fmaxf(s1[0], 1e-12f);
    float mu_s[3], mu_d[3];
    for (int c = 0; c < 3; ++c) {
        mu_s[c] = s1[1 + c] / wsum;
        mu_d[c] = s1[4 + c] / wsum;
    }
    float s2[10];
    for (int k = 0; k < 10; ++k) s2[k] = 0.0f;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const float w = ((is_inlier(Sb, p_a + 3 * m, p_b + 3 * m,
                                    valid[m] != 0, thresh) ? 1.0f : 0.0f)
                         + 1e-9f) / wsum;
        float sc[3], dc[3];
        for (int c = 0; c < 3; ++c) {
            sc[c] = p_a[3 * m + c] - mu_s[c];
            dc[c] = p_b[3 * m + c] - mu_d[c];
        }
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) s2[3 * i + j] += w * dc[i] * sc[j];
        }
        s2[9] += w * (sc[0] * sc[0] + sc[1] * sc[1] + sc[2] * sc[2]);
    }
    block_sums<10>(s2, fscratch);
    if (threadIdx.x == 0) {
        float W[3][3];
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) W[i][j] = s2[3 * i + j];
        }
        horn_close(mu_s, mu_d, W, s2[9], fix_scale != 0, Sr);
    }
    __syncthreads();
    int c = 0;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        c += is_inlier(Sr, p_a + 3 * m, p_b + 3 * m, valid[m] != 0, thresh);
    }
    c = block_sum_i(c, scratch);
    if (threadIdx.x == 0 && c >= best_count) {
        for (int k = 0; k < 8; ++k) Sb[k] = Sr[k];  // keep the polish
    }
    __syncthreads();

    // Huber-IRLS Gauss-Newton on the 7-dof tangent
    for (int it = 0; it < iters; ++it) {
        float acc[35];
        for (int k = 0; k < 35; ++k) acc[k] = 0.0f;
        for (int m = threadIdx.x; m < M; m += blockDim.x) {
            float y[3];
            sim3_apply(Sb, p_a + 3 * m, y);
            const float r[3] = {y[0] - p_b[3 * m], y[1] - p_b[3 * m + 1],
                                y[2] - p_b[3 * m + 2]};
            const float d = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
            const float w = (valid[m] != 0 && d < thresh * 3.0f)
                                ? fminf(1.0f, thresh / fmaxf(d, 1e-9f))
                                : 0.0f;
            if (w == 0.0f) continue;
            const float J[3][7] = {
                {1.f, 0.f, 0.f, 0.f, y[2], -y[1], y[0]},
                {0.f, 1.f, 0.f, -y[2], 0.f, y[0], y[1]},
                {0.f, 0.f, 1.f, y[1], -y[0], 0.f, y[2]}};
            int k = 0;
            for (int a = 0; a < 7; ++a) {
                for (int b = a; b < 7; ++b) {
                    acc[k++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] +
                                     J[2][a] * J[2][b]);
                }
            }
            for (int a = 0; a < 7; ++a) {
                acc[28 + a] += w * (J[0][a] * r[0] + J[1][a] * r[1] +
                                    J[2][a] * r[2]);
            }
        }
        block_sums<35>(acc, fscratch);
        if (threadIdx.x == 0) {
            double Hm[7][7], g[7], dx[7];
            int k = 0;
            for (int a = 0; a < 7; ++a) {
                for (int b = a; b < 7; ++b) {
                    Hm[a][b] = Hm[b][a] = acc[k++];
                }
                g[a] = -(double)acc[28 + a];
            }
            if (fix_scale) {
                for (int a = 0; a < 7; ++a) Hm[6][a] = Hm[a][6] = 0.0;
                Hm[6][6] = 1.0;
                g[6] = 0.0;
            }
            for (int a = 0; a < 7; ++a) Hm[a][a] += 1e-5;
            solve_dense<7>(Hm, g, dx);
            float xi[7], E[8], Sn[8];
            for (int a = 0; a < 7; ++a) {
                xi[a] = isfinite(dx[a]) ? (float)dx[a] : 0.0f;
            }
            sim3_exp(xi, E);
            sim3_mul(E, Sb, Sn);
            quat_normalize(Sn);
            Sn[7] = fabsf(Sn[7]);
            for (int a = 0; a < 8; ++a) Sb[a] = Sn[a];
        }
        __syncthreads();
    }
    c = 0;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const bool in = is_inlier(Sb, p_a + 3 * m, p_b + 3 * m,
                                  valid[m] != 0, thresh);
        inl_out[m] = in ? 1 : 0;
        c += in;
    }
    c = block_sum_i(c, scratch);
    if (threadIdx.x == 0) {
        *n_out = c;
        for (int k = 0; k < 8; ++k) S_out[k] = Sb[k];
    }
}

// ---- PnP -----------------------------------------------------------------

__global__ void __launch_bounds__(128)
    pnp_hyp_kernel(const float* __restrict__ xw, const float* __restrict__ uv,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ cam,
                   const int* __restrict__ picks, int M, float r2,
                   float* __restrict__ poses, int* __restrict__ counts) {
    __shared__ float T[7];
    __shared__ int scratch[32];
    const int h = blockIdx.x;
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    if (threadIdx.x == 0) {
        double AtA[12][12], V[12][12];
        for (int i = 0; i < 12; ++i) {
            for (int j = 0; j < 12; ++j) AtA[i][j] = 0.0;
        }
        float X0[3] = {0.f, 0.f, 0.f};
        for (int k = 0; k < 6; ++k) {
            const int i = picks[6 * h + k];
            const float X[4] = {xw[3 * i], xw[3 * i + 1], xw[3 * i + 2], 1.0f};
            if (k == 0) {
                for (int c = 0; c < 3; ++c) X0[c] = X[c];
            }
            const float x = (uv[2 * i] - cx) / fx;
            const float y = (uv[2 * i + 1] - cy) / fy;
            float r1[12], r2r[12];
            for (int c = 0; c < 4; ++c) {
                r1[c] = X[c];
                r1[4 + c] = 0.0f;
                r1[8 + c] = -x * X[c];
                r2r[c] = 0.0f;
                r2r[4 + c] = X[c];
                r2r[8 + c] = -y * X[c];
            }
            for (int a = 0; a < 12; ++a) {
                for (int b = 0; b < 12; ++b) {
                    AtA[a][b] += (double)r1[a] * r1[b] +
                                 (double)r2r[a] * r2r[b];
                }
            }
        }
        jacobi_eigen<12>(AtA, V);
        int mi = 0;
        for (int i = 1; i < 12; ++i) {
            if (AtA[i][i] < AtA[mi][mi]) mi = i;
        }
        float Mm[3][3], t[3];
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c) Mm[r][c] = (float)V[4 * r + c][mi];
            t[r] = (float)V[4 * r + 3][mi];
        }
        float s0 = 0.0f;
        for (int r = 0; r < 3; ++r) {
            s0 += X0[0] * Mm[r][0] + X0[1] * Mm[r][1] + X0[2] * Mm[r][2] +
                  t[r];
        }
        const float depth = s0 * 0.0f + (X0[0] * Mm[2][0] + X0[1] * Mm[2][1] +
                                         X0[2] * Mm[2][2] + t[2]);
        const float sg = isnan(depth) ? depth
                                      : (depth > 0.0f ? 1.0f
                                                      : (depth < 0.0f ? -1.0f
                                                                      : 0.0f));
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c) Mm[r][c] *= sg;
            t[r] *= sg;
        }
        float R[3][3], sv[3];
        procrustes(Mm, R, sv);
        bool finite = true;
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c) finite = finite && isfinite(Mm[r][c]);
        }
        const float scale = (sv[0] + sv[1] + sv[2]) / 3.0f;
        float q[4];
        matrix_to_quat(R, q);
        for (int c = 0; c < 4; ++c) T[c] = finite ? q[c] : NAN;
        for (int c = 0; c < 3; ++c) T[4 + c] = t[c] / fmaxf(scale, 1e-9f);
    }
    __syncthreads();
    bool finite = true;
    for (int c = 0; c < 7; ++c) finite = finite && isfinite(T[c]);
    int cnt = 0;
    if (finite) {
        for (int m = threadIdx.x; m < M; m += blockDim.x) {
            float p[3];
            quat_rot(T, xw + 3 * m, p);
            for (int c = 0; c < 3; ++c) p[c] += T[4 + c];
            const float z = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
            const float iz = 1.0f / z;
            const float du = fx * p[0] * iz + cx - uv[2 * m];
            const float dv = fy * p[1] * iz + cy - uv[2 * m + 1];
            cnt += (valid[m] != 0 && p[2] > 0.05f && du * du + dv * dv < r2);
        }
    }
    cnt = block_sum_i(cnt, scratch);
    if (threadIdx.x == 0) {
        counts[h] = finite ? cnt : -1;
        for (int c = 0; c < 7; ++c) poses[7 * h + c] = T[c];
    }
}

__global__ void pnp_pick_kernel(const float* __restrict__ poses,
                                const int* __restrict__ counts, int H,
                                float* __restrict__ T0) {
    if (threadIdx.x != 0) return;
    int b = 0;
    for (int h = 1; h < H; ++h) {
        if (counts[h] > counts[b]) b = h;
    }
    bool finite = true;
    for (int c = 0; c < 7; ++c) finite = finite && isfinite(poses[7 * b + c]);
    for (int c = 0; c < 7; ++c) {
        T0[c] = finite ? poses[7 * b + c] : (c == 0 ? 1.0f : 0.0f);
    }
}

}  // namespace

// p_a, p_b: (M, 3) f32; valid: (M,) u8; samples: (H, 3) i32.  Scratch
// S_hyp (H, 8), counts (H,).  Outputs S (8,), n_inliers (), inliers (M,)
// u8.
VSG_API int vsg_verify_sim3(const float* p_a, const float* p_b,
                            const uint8_t* valid, const int* samples, int M,
                            int H, float thresh, int fix_scale, int iters,
                            float* S_hyp, int* counts, float* S, int* n_inl,
                            uint8_t* inliers, cudaStream_t stream) {
    if (H == 0) return 0;
    sim3_hyp_kernel<<<H, BT, 0, stream>>>(p_a, p_b, valid, samples, M, thresh,
                                          fix_scale, S_hyp, counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sim3_finish_kernel<<<1, FT, 0, stream>>>(p_a, p_b, valid, M, H, thresh,
                                             fix_scale, iters, S_hyp, counts,
                                             S, n_inl, inliers);
    return (int)cudaGetLastError();
}

// xw: (M, 3) f32 world points, uv: (M, 2) f32 pixels, valid: (M,) u8,
// cam: [fx, fy, cx, cy], picks: (H, 6) i32, r2: inlier radius^2.  Outputs
// poses (H, 7), counts (H,) i32 (-1 = not finite), T0 (7,) the winner.
VSG_API int vsg_pnp_hypotheses(const float* xw, const float* uv,
                               const uint8_t* valid, const float* cam,
                               const int* picks, int M, int H, float r2,
                               float* poses, int* counts, float* T0,
                               cudaStream_t stream) {
    if (H == 0) return 0;
    pnp_hyp_kernel<<<H, 128, 0, stream>>>(xw, uv, valid, cam, picks, M, r2,
                                          poses, counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pnp_pick_kernel<<<1, 32, 0, stream>>>(poses, counts, H, T0);
    return (int)cudaGetLastError();
}
