// K18: IMU preintegration of one frame window, folded into the running
// keyframe-to-keyframe window, in one launch.
//
// Replaces visual_sgraphs_tpu/inertial/preintegration.py::preintegrate
// (a lax.scan of _step over the window, jitted as pipeline.py:37) and the
// merge into the keyframe window that follows it (pipeline.py:123).
//
// What bounds it here: latency.  A window is at most 64 samples (~7 at
// 200 Hz and 30 fps), each a chain of small dense updates that depends on
// the one before: ~1 KB in, ~1 KB out, ~2e4 flops per sample.  As
// separate PyTorch ops a window is ~40 launches per sample.
//
// Design: one block per window walks the samples in order.  Thread 0
// computes each step's 3x3 quantities (ΔR as a matrix, the incremental
// rotation exp(w dt), the right Jacobian Jr(w dt) = Jl(-w dt), R [a]x) and
// the 9x9 transition A and 9x6 noise map B into shared memory; then 81
// threads propagate the covariance A Σ Aᵀ + B Sn Bᵀ / dt (one entry each,
// in two passes) while 45 others update the five bias Jacobians.  Padded
// samples are skipped (the reference's where(valid, new, old)).  After the
// window, the same threads compose it onto the keyframe window (merge).
// Everything stays float32, as the reference integrates; sums run in the
// reference's order, with the compiler's fused multiply-adds.
#include "lie.cuh"

namespace {

constexpr int P = 143;  // packed Preintegrated (preintegration.py::pack)
constexpr int O_DR = 0, O_DV = 4, O_DP = 7, O_J = 10, O_COV = 55,
              O_DT = 136, O_BG = 137, O_BA = 140;
// bias Jacobians in packed order: JRg, JVg, JVa, JPg, JPa
constexpr int J_RG = 0, J_VG = 1, J_VA = 2, J_PG = 3, J_PA = 4;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
preint_kernel(const float* __restrict__ since,
              const float* __restrict__ samples, int n,
              const float* __restrict__ bias_g,
              const float* __restrict__ bias_a, float ng2, float na2,
              float* __restrict__ out) {
    __shared__ float s[P];      // the window being integrated
    __shared__ float A[81];     // transition (row-major 9x9)
    __shared__ float Bm[54];    // noise map (row-major 9x6)
    __shared__ float tmp[81];   // A Σ
    __shared__ float Jn[45];    // updated bias Jacobians
    __shared__ float R[9], Rk[9], Jr[9], RAJ[9];
    __shared__ float dtv_s, inv_dt_s;
    const int tid = threadIdx.x;
    for (int i = tid; i < P; i += THREADS) s[i] = 0.0f;
    __syncthreads();
    if (tid == 0) {
        s[O_DR] = 1.0f;
        for (int i = 0; i < 3; ++i) {
            s[O_BG + i] = bias_g[i];
            s[O_BA + i] = bias_a[i];
        }
    }
    __syncthreads();

    float dRk[4];  // thread 0: this step's incremental rotation
    for (int k = 0; k < n; ++k) {
        const float* row = samples + 8 * k;
        if (row[7] == 0.0f) continue;  // padding: uniform over the block
        if (tid == 0) {
            const float dtv = row[6];
            float w[3], a[3];
            for (int i = 0; i < 3; ++i) {
                w[i] = row[i] - s[O_BG + i];
                a[i] = row[3 + i] - s[O_BA + i];
            }
            quat_to_mat(s + O_DR, R);
            float Ra[3];
            for (int i = 0; i < 3; ++i) {
                Ra[i] = R[3 * i] * a[0] + R[3 * i + 1] * a[1] +
                        R[3 * i + 2] * a[2];
            }
            for (int i = 0; i < 3; ++i) {
                s[O_DP + i] = s[O_DP + i] + s[O_DV + i] * dtv +
                              0.5f * Ra[i] * dtv * dtv;
                s[O_DV + i] = s[O_DV + i] + Ra[i] * dtv;
            }
            const float ahat[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0],
                                   -a[1], a[0], 0.0f};
            float wdt[3], mwdt[3];
            for (int i = 0; i < 3; ++i) {
                wdt[i] = w[i] * dtv;
                mwdt[i] = -w[i] * dtv;
            }
            so3_exp(wdt, dRk);
            quat_to_mat(dRk, Rk);
            so3_left_jac(mwdt, Jr);
            float RA[9];
            mat3_mul(R, ahat, RA);
            mat3_mul(RA, s + O_J + 9 * J_RG, RAJ);
            for (int i = 0; i < 81; ++i) A[i] = 0.0f;
            for (int i = 0; i < 54; ++i) Bm[i] = 0.0f;
            for (int i = 0; i < 3; ++i) {
                for (int j = 0; j < 3; ++j) {
                    A[9 * i + j] = Rk[3 * j + i];
                    A[9 * (3 + i) + j] = -RA[3 * i + j] * dtv;
                    A[9 * (6 + i) + j] = -0.5f * RA[3 * i + j] * dtv * dtv;
                    Bm[6 * i + j] = Jr[3 * i + j] * dtv;
                    Bm[6 * (3 + i) + 3 + j] = R[3 * i + j] * dtv;
                    Bm[6 * (6 + i) + 3 + j] = 0.5f * R[3 * i + j] * dtv * dtv;
                }
                A[9 * (3 + i) + 3 + i] = 1.0f;
                A[9 * (6 + i) + 3 + i] = dtv;
                A[9 * (6 + i) + 6 + i] = 1.0f;
            }
            dtv_s = dtv;
            inv_dt_s = dtv > 0.0f ? 1.0f / fmaxf(dtv, 1e-9f) : 0.0f;
        }
        __syncthreads();
        const float dtv = dtv_s;
        if (tid < 81) {
            const int i = tid / 9, j = tid % 9;
            float acc = 0.0f;
            for (int q = 0; q < 9; ++q) acc += A[9 * i + q] * s[O_COV + 9 * q + j];
            tmp[tid] = acc;
        } else if (tid < 126) {
            const int m = (tid - 81) / 9, e = (tid - 81) % 9;
            const int r = e / 3, c = e % 3;
            const float* J = s + O_J;
            float v;
            if (m == J_RG) {
                float t = 0.0f;  // (Rkᵀ JRg)[r][c]
                for (int q = 0; q < 3; ++q) t += Rk[3 * q + r] * J[9 * J_RG + 3 * q + c];
                v = t - Jr[e] * dtv;
            } else if (m == J_VG) {
                v = J[9 * J_VG + e] - RAJ[e] * dtv;
            } else if (m == J_VA) {
                v = J[9 * J_VA + e] - R[e] * dtv;
            } else if (m == J_PG) {
                v = J[9 * J_PG + e] + J[9 * J_VG + e] * dtv -
                    0.5f * RAJ[e] * dtv * dtv;
            } else {
                v = J[9 * J_PA + e] + J[9 * J_VA + e] * dtv -
                    0.5f * R[e] * dtv * dtv;
            }
            Jn[tid - 81] = v;
        }
        __syncthreads();
        if (tid < 81) {
            const int i = tid / 9, j = tid % 9;
            float acc = 0.0f, noise = 0.0f;
            for (int q = 0; q < 9; ++q) acc += tmp[9 * i + q] * A[9 * j + q];
            for (int q = 0; q < 6; ++q) {
                noise += Bm[6 * i + q] * (q < 3 ? ng2 : na2) * Bm[6 * j + q];
            }
            s[O_COV + tid] = acc + noise * inv_dt_s;
        } else if (tid < 126) {
            s[O_J + tid - 81] = Jn[tid - 81];
        }
        if (tid == 0) {
            float q[4];
            quat_mul(s + O_DR, dRk, q);
            quat_normalize(q);
            for (int i = 0; i < 4; ++i) s[O_DR + i] = q[i];
            s[O_DT] = s[O_DT] + dtv;
        }
        __syncthreads();
    }

    // ---- the window, then merge(since, window)
    for (int i = tid; i < P; i += THREADS) out[i] = s[i];
    float* m = out + P;
    const float* a = since;
    __shared__ float Rb[9], RaM[9];
    if (tid == 0) {
        const float bdt = s[O_DT];
        quat_to_mat(a + O_DR, RaM);
        quat_to_mat(s + O_DR, Rb);
        for (int i = 0; i < 3; ++i) {
            float rp = 0.0f, rv = 0.0f;
            for (int q = 0; q < 3; ++q) {
                rp += RaM[3 * i + q] * s[O_DP + q];
                rv += RaM[3 * i + q] * s[O_DV + q];
            }
            m[O_DP + i] = a[O_DP + i] + a[O_DV + i] * bdt + rp;
            m[O_DV + i] = a[O_DV + i] + rv;
        }
        float q[4];
        quat_mul(a + O_DR, s + O_DR, q);
        quat_normalize(q);
        for (int i = 0; i < 4; ++i) m[O_DR + i] = q[i];
        for (int i = 0; i < 81; ++i) A[i] = 0.0f;
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) A[9 * i + j] = Rb[3 * j + i];
            A[9 * (3 + i) + 3 + i] = 1.0f;
            A[9 * (6 + i) + 3 + i] = bdt;
            A[9 * (6 + i) + 6 + i] = 1.0f;
        }
        m[O_DT] = a[O_DT] + bdt;
        for (int i = 0; i < 3; ++i) {
            m[O_BG + i] = a[O_BG + i];
            m[O_BA + i] = a[O_BA + i];
        }
    }
    __syncthreads();
    const float bdt = s[O_DT];
    if (tid < 81) {
        const int i = tid / 9, j = tid % 9;
        float acc = 0.0f;
        for (int q = 0; q < 9; ++q) acc += A[9 * i + q] * a[O_COV + 9 * q + j];
        tmp[tid] = acc;
    } else if (tid < 126) {
        const int mm = (tid - 81) / 9, e = (tid - 81) % 9;
        const int r = e / 3, c = e % 3;
        const float* Ja = a + O_J;
        const float* Jb = s + O_J;
        float v;
        if (mm == J_RG) {
            float t = 0.0f;  // Rbᵀ JRg_a
            for (int q = 0; q < 3; ++q) t += Rb[3 * q + r] * Ja[3 * q + c];
            v = t + Jb[e];
        } else {
            float t = 0.0f;  // Ra J_b
            for (int q = 0; q < 3; ++q) {
                t += RaM[3 * r + q] * Jb[9 * mm + 3 * q + c];
            }
            if (mm == J_PG) {
                v = Ja[9 * J_PG + e] + Ja[9 * J_VG + e] * bdt + t;
            } else if (mm == J_PA) {
                v = Ja[9 * J_PA + e] + Ja[9 * J_VA + e] * bdt + t;
            } else {
                v = Ja[9 * mm + e] + t;
            }
        }
        m[O_J + tid - 81] = v;
    }
    __syncthreads();
    if (tid < 81) {
        const int i = tid / 9, j = tid % 9;
        float acc = 0.0f;
        for (int q = 0; q < 9; ++q) acc += tmp[9 * i + q] * A[9 * j + q];
        m[O_COV + tid] = acc + s[O_COV + tid];
    }
}

}  // namespace

// since: (143,) f32 packed keyframe window; samples: (n, 8) f32
// [wx wy wz ax ay az dt valid], n <= 64; bias_g / bias_a: (3,) f32, the
// linearisation biases; ng2 / na2: the noise densities squared.  Writes
// out (2, 143): the window, then merge(since, window).
VSG_API int vsg_preint(const float* since, const float* samples, int n,
                       const float* bias_g, const float* bias_a, float ng2,
                       float na2, float* out, cudaStream_t stream) {
    preint_kernel<<<1, THREADS, 0, stream>>>(since, samples, n, bias_g,
                                             bias_a, ng2, na2, out);
    return (int)cudaGetLastError();
}
