// K8: landmark-grouped Schur reduction of the windowed bundle adjustment
// and the landmark back-substitution.
//
// Replaces visual_sgraphs_tpu/parallel/dist_ba.py::_landmark_terms,
// ::_local_reduced_system, ::_inv3x3 and ::_back_substitute.  The JAX
// version turns every contraction into a matmul over a one-hot (n, O, K)
// keyframe assignment (the TPU's matrix unit; a scatter serialised there).
//
// What bounds it here: operations and atomics.  Per landmark (n = 8,192,
// O = 12 observations, L = 11 keyframes) it builds O 3x6 / 3x3
// Jacobians, Hxx, W, gp, and O^2 6x6 pair blocks W_a Hxx^-1 W_b^T (~1,300
// flops per pair, ~200 MFLOP in all); the reads are ~1.3 MB of tables and
// the writes the (n, O, 6, 3) W cache (4.7 MB).  FP32 throughout: the
// terms span about eight orders of magnitude, so no TF32 and no tensor
// cores in this version.
//
// Design: one warp per landmark, one lane per observation (O <= 32).  Each
// lane computes its residual, Jacobians and robust weight in registers;
// warp sums give Hxx, bx and the cost; every lane inverts the damped Hxx
// in closed form.  Lane a then adds Hpp_a into its keyframe's diagonal
// block, W_a Hinv bx - gp_a into the rhs, and for every lane b (fetched by
// shuffles) the block W_a Hinv W_b^T at (k_a, k_b).  For L <= 16 the
// (6L)^2 accumulator lives in shared memory per block (<= 40 KB) and is
// flushed with one global atomicAdd per non-zero entry; for larger L
// (global BA) the warps add into global memory directly.  A second kernel
// symmetrises S = blockdiag(Hpp) - (A + A^T) / 2 as the reference does.
// The back-substitution is one thread per landmark.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int SHARED_MAX_L = 16;

__global__ void __launch_bounds__(WARPS * 32)
schur_reduce_kernel(const float* __restrict__ pose,
                    const float* __restrict__ pts,
                    const int* __restrict__ kf_tab,
                    const float* __restrict__ uvr,
                    const uint8_t* __restrict__ val,
                    const float* __restrict__ cam_K,
                    const float* __restrict__ bf_ptr, int n, int O, int L,
                    float lam, float huber, float* __restrict__ Hinv_out,
                    float* __restrict__ bx_out, float* __restrict__ W_out,
                    float* __restrict__ g_acc, int use_shared) {
    extern __shared__ float sh[];
    const int dim = 6 * L;
    const int total = dim * dim + 36 * L + dim + 1;
    float* acc = use_shared ? sh : g_acc;
    if (use_shared) {
        for (int k = threadIdx.x; k < total; k += blockDim.x) sh[k] = 0.0f;
        __syncthreads();
    }
    float* A = acc;                    // (dim, dim) pair sums
    float* S1 = acc + dim * dim;       // (L, 6, 6) Hpp blocks
    float* rhs = S1 + 36 * L;          // (dim,)
    float* cost_acc = rhs + dim;       // (1,)

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float fx = cam_K[0], fy = cam_K[1], cx = cam_K[2], cy = cam_K[3];
    const float bf = *bf_ptr;

    for (int lm = blockIdx.x * WARPS + warp; lm < n;
         lm += gridDim.x * WARPS) {
        const bool active = lane < O;
        const float X0 = pts[3 * lm], X1 = pts[3 * lm + 1],
                    X2 = pts[3 * lm + 2];
        float r[3] = {0.f, 0.f, 0.f};
        float Jp[3][6];
        float Jx[3][3];
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 6; ++j) Jp[i][j] = 0.f;
            for (int j = 0; j < 3; ++j) Jx[i][j] = 0.f;
        }
        float w = 0.f, chi2 = 0.f;
        int k = -1;
        bool slot_ok = false;
        if (active) {
            const int o = lm * O + lane;
            k = kf_tab[o];
            const bool ov = val[o] != 0;
            slot_ok = ov && k >= 0;
            const float* T = pose + 7 * max(k, 0);
            const float qw = T[0], qx = T[1], qy = T[2], qz = T[3];
            const float R[3][3] = {
                {1.f - 2.f * (qy * qy + qz * qz), 2.f * (qx * qy - qw * qz),
                 2.f * (qx * qz + qw * qy)},
                {2.f * (qx * qy + qw * qz), 1.f - 2.f * (qx * qx + qz * qz),
                 2.f * (qy * qz - qw * qx)},
                {2.f * (qx * qz - qw * qy), 2.f * (qy * qz + qw * qx),
                 1.f - 2.f * (qx * qx + qy * qy)}};
            float p[3];
            for (int i = 0; i < 3; ++i) {
                p[i] = R[i][0] * X0 + R[i][1] * X1 + R[i][2] * X2 + T[4 + i];
            }
            const float z = fmaxf(p[2], 1e-6f);
            const float iz = 1.0f / z;
            const float u_hat = fx * p[0] * iz + cx;
            const float v_hat = fy * p[1] * iz + cy;
            const float uo = uvr[3 * o], vo = uvr[3 * o + 1],
                        ro = uvr[3 * o + 2];
            const bool has_ur = ro > 0.f;
            const float ur_hat = u_hat - bf * iz;
            const float disp = fmaxf(uo - ro, 1e-3f);
            const float z_meas = has_ur ? bf / disp : 1.0f;
            const float q = 2.5f / fmaxf(z_meas, 0.1f);
            const float w_ur = fminf(q * q, 1.0f);
            r[0] = u_hat - uo;
            r[1] = v_hat - vo;
            r[2] = has_ur ? (ur_hat - ro) * w_ur : 0.f;
            chi2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
            const bool ok = ov && k >= 0 && p[2] > 0.05f;
            w = ok ? fminf(huber / sqrtf(fmaxf(chi2, 1e-12f)), 1.0f) : 0.f;
            const float iz2 = iz * iz;
            const float sur = has_ur ? w_ur : 0.f;
            const float Jpp[3][3] = {
                {fx * iz, 0.f, -fx * p[0] * iz2},
                {0.f, fy * iz, -fy * p[1] * iz2},
                {fx * iz * sur, 0.f, (-fx * p[0] + bf) * iz2 * sur}};
            // dp/dxi = [I | -hat(p)]
            const float mh[3][3] = {{0.f, p[2], -p[1]},
                                    {-p[2], 0.f, p[0]},
                                    {p[1], -p[0], 0.f}};
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 3; ++j) {
                    Jp[i][j] = Jpp[i][j];
                    float s = 0.f, t = 0.f;
                    for (int m = 0; m < 3; ++m) {
                        s += Jpp[i][m] * mh[m][j];
                        t += Jpp[i][m] * R[m][j];
                    }
                    Jp[i][3 + j] = s;
                    Jx[i][j] = t;
                }
            }
        }
        // landmark block sums over the observations
        float hs[10];
        {
            int t = 0;
            for (int i = 0; i < 3; ++i) {
                for (int j = i; j < 3; ++j) {
                    float s = 0.f;
                    for (int m = 0; m < 3; ++m) s += Jx[m][i] * Jx[m][j];
                    hs[t++] = w * s;
                }
            }
            for (int i = 0; i < 3; ++i) {
                float s = 0.f;
                for (int m = 0; m < 3; ++m) s += Jx[m][i] * r[m];
                hs[6 + i] = w * s;
            }
            hs[9] = w * chi2;
        }
        for (int t = 0; t < 10; ++t) hs[t] = vsg_warp_sum(hs[t]);
        float H[3][3] = {{hs[0], hs[1], hs[2]},
                         {hs[1], hs[3], hs[4]},
                         {hs[2], hs[4], hs[5]}};
        const float bx[3] = {hs[6], hs[7], hs[8]};
        for (int i = 0; i < 3; ++i) {
            H[i][i] += lam * fmaxf(H[i][i], 1e-6f) + 1e-5f;
        }
        const float a = H[0][0], b = H[0][1], c = H[0][2], d = H[1][0],
                    e = H[1][1], f = H[1][2], g = H[2][0], h = H[2][1],
                    ii = H[2][2];
        const float cA = e * ii - f * h, cB = c * h - b * ii,
                    cC = b * f - c * e, cD = f * g - d * ii,
                    cE = a * ii - c * g, cF = c * d - a * f,
                    cG = d * h - e * g, cH = b * g - a * h,
                    cI = a * e - b * d;
        const float det = a * cA + b * cD + c * cG;
        const float inv_det = 1.0f / (fabsf(det) > 1e-12f ? det : 1e-12f);
        const float Hi[3][3] = {{cA * inv_det, cB * inv_det, cC * inv_det},
                                {cD * inv_det, cE * inv_det, cF * inv_det},
                                {cG * inv_det, cH * inv_det, cI * inv_det}};
        if (lane == 0) {
            for (int i = 0; i < 3; ++i) {
                bx_out[3 * lm + i] = bx[i];
                for (int j = 0; j < 3; ++j) Hinv_out[9 * lm + 3 * i + j] = Hi[i][j];
            }
            atomicAdd(cost_acc, hs[9]);
        }
        // per-observation blocks
        float Wa[6][3], V[3][6];
        for (int i = 0; i < 6; ++i) {
            for (int j = 0; j < 3; ++j) {
                float s = 0.f;
                for (int m = 0; m < 3; ++m) s += Jp[m][i] * Jx[m][j];
                Wa[i][j] = w * s;
            }
        }
        if (active) {
            float* Wo = W_out + 18 * (lm * O + lane);
            for (int i = 0; i < 6; ++i) {
                for (int j = 0; j < 3; ++j) Wo[3 * i + j] = Wa[i][j];
            }
        }
        // V = Hinv W_a^T (3, 6)
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 6; ++j) {
                V[i][j] = Hi[i][0] * Wa[j][0] + Hi[i][1] * Wa[j][1] +
                          Hi[i][2] * Wa[j][2];
            }
        }
        if (slot_ok) {
            const float hb[3] = {
                Hi[0][0] * bx[0] + Hi[0][1] * bx[1] + Hi[0][2] * bx[2],
                Hi[1][0] * bx[0] + Hi[1][1] * bx[1] + Hi[1][2] * bx[2],
                Hi[2][0] * bx[0] + Hi[2][1] * bx[1] + Hi[2][2] * bx[2]};
            float* S1k = S1 + 36 * k;
            for (int i = 0; i < 6; ++i) {
                float gp = 0.f;
                for (int m = 0; m < 3; ++m) gp += Jp[m][i] * r[m];
                const float wb = Wa[i][0] * hb[0] + Wa[i][1] * hb[1] +
                                 Wa[i][2] * hb[2];
                atomicAdd(&rhs[6 * k + i], wb - w * gp);
                for (int j = 0; j < 6; ++j) {
                    float s = 0.f;
                    for (int m = 0; m < 3; ++m) s += Jp[m][i] * Jp[m][j];
                    if (s != 0.f) atomicAdd(&S1k[6 * i + j], w * s);
                }
            }
        }
        // pair blocks W_a Hinv W_b^T at (k_a, k_b)
        for (int bl = 0; bl < O; ++bl) {
            const int kb = __shfl_sync(0xffffffffu, k, bl);
            const bool okb = __shfl_sync(0xffffffffu, slot_ok ? 1 : 0, bl) != 0;
            float Vb[3][6];
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 6; ++j) {
                    Vb[i][j] = __shfl_sync(0xffffffffu, V[i][j], bl);
                }
            }
            if (!(slot_ok && okb)) continue;
            float* Ab = A + (6 * k) * dim + 6 * kb;
            for (int i = 0; i < 6; ++i) {
                for (int j = 0; j < 6; ++j) {
                    const float s = Wa[i][0] * Vb[0][j] + Wa[i][1] * Vb[1][j] +
                                    Wa[i][2] * Vb[2][j];
                    if (s != 0.f) atomicAdd(&Ab[i * dim + j], s);
                }
            }
        }
    }
    if (use_shared) {
        __syncthreads();
        for (int t = threadIdx.x; t < total; t += blockDim.x) {
            if (sh[t] != 0.0f) atomicAdd(&g_acc[t], sh[t]);
        }
    }
}

__global__ void schur_finalize(const float* __restrict__ g_acc, int L,
                               float* __restrict__ S, float* __restrict__ rhs,
                               float* __restrict__ cost) {
    const int dim = 6 * L;
    const float* A = g_acc;
    const float* S1 = g_acc + dim * dim;
    const float* r = S1 + 36 * L;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < dim * dim) {
        const int i = t / dim, j = t % dim;
        float s = -0.5f * (A[i * dim + j] + A[j * dim + i]);
        if (i / 6 == j / 6) s += S1[36 * (i / 6) + 6 * (i % 6) + (j % 6)];
        S[t] = s;
    }
    if (t < dim) rhs[t] = r[t];
    if (t == 0) *cost = r[dim];
}

__global__ void schur_backsub(const float* __restrict__ Hinv,
                              const float* __restrict__ bx,
                              const float* __restrict__ W,
                              const int* __restrict__ kf_tab,
                              const uint8_t* __restrict__ val,
                              const float* __restrict__ dx6, int n, int O,
                              int L, float* __restrict__ dxe) {
    const int lm = blockIdx.x * blockDim.x + threadIdx.x;
    if (lm >= n) return;
    float y[3] = {bx[3 * lm], bx[3 * lm + 1], bx[3 * lm + 2]};
    for (int a = 0; a < O; ++a) {
        const int o = lm * O + a;
        const int k = kf_tab[o];
        if (!(val[o] != 0 && k >= 0 && k < L)) continue;
        const float* Wo = W + 18 * o;
        const float* d = dx6 + 6 * k;
        for (int r = 0; r < 6; ++r) {
            y[0] += Wo[3 * r] * d[r];
            y[1] += Wo[3 * r + 1] * d[r];
            y[2] += Wo[3 * r + 2] * d[r];
        }
    }
    const float* Hi = Hinv + 9 * lm;
    for (int i = 0; i < 3; ++i) {
        const float v = -(Hi[3 * i] * y[0] + Hi[3 * i + 1] * y[1] +
                          Hi[3 * i + 2] * y[2]);
        dxe[3 * lm + i] = isfinite(v) ? v : 0.0f;
    }
}

}  // namespace

// pose (L, 7) f32 T_cw, pts (n, 3) f32, kf_tab (n, O) i32 window rows
// (-1 none), uvr (n, O, 3) f32, val (n, O) u8, cam_K (4,) f32, bf () f32
// on the device.  Outputs S (6L, 6L), rhs (6L,), Hinv (n, 3, 3), bx (n, 3),
// W (n, O, 6, 3), cost ().  Scratch acc (36 L^2 + 36 L + 6 L + 1,) f32,
// zeroed here.
VSG_API int vsg_schur_reduce(const float* pose, const float* pts,
                             const int* kf_tab, const float* uvr,
                             const uint8_t* val, const float* cam_K,
                             const float* bf, int n, int O, int L, float lam,
                             float huber, float* S, float* rhs, float* Hinv,
                             float* bx, float* W, float* cost, float* acc,
                             cudaStream_t stream) {
    if (O > 32) return (int)cudaErrorInvalidValue;
    const int dim = 6 * L;
    const int total = dim * dim + 36 * L + dim + 1;
    cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * total, stream);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        int dev = 0, sms = 132;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        const int use_shared = L <= SHARED_MAX_L ? 1 : 0;
        const size_t shmem = use_shared ? sizeof(float) * total : 0;
        int blocks = (n + WARPS - 1) / WARPS;
        blocks = min(blocks, 2 * sms);
        schur_reduce_kernel<<<blocks, WARPS * 32, shmem, stream>>>(
            pose, pts, kf_tab, uvr, val, cam_K, bf, n, O, L, lam, huber, Hinv,
            bx, W, acc, use_shared);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    schur_finalize<<<(dim * dim + 255) / 256, 256, 0, stream>>>(acc, L, S,
                                                                rhs, cost);
    return (int)cudaGetLastError();
}

// Hinv (n, 3, 3), bx (n, 3), W (n, O, 6, 3), kf_tab (n, O) i32, val (n, O)
// u8, dx6 (L, 6) the solved camera steps.  Output dxe (n, 3) (non-finite
// -> 0).
VSG_API int vsg_schur_backsub(const float* Hinv, const float* bx,
                              const float* W, const int* kf_tab,
                              const uint8_t* val, const float* dx6, int n,
                              int O, int L, float* dxe, cudaStream_t stream) {
    if (n == 0) return 0;
    schur_backsub<<<(n + 127) / 128, 128, 0, stream>>>(Hinv, bx, W, kf_tab,
                                                       val, dx6, n, O, L, dxe);
    return (int)cudaGetLastError();
}
