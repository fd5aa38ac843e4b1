// K18: one inertial frame in one launch: the frame's IMU preintegration,
// its merge into the running keyframe-to-keyframe window and, once the
// IMU is initialised, the dead-reckoned pose and velocity of the frame.
//
// Replaces visual_sgraphs_tpu/inertial/preintegration.py::preintegrate (a
// lax.scan of _step over the window, jitted as pipeline.py:37), the merge
// into the keyframe window that follows it (pipeline.py:123) and
// pipeline.py:43 predict_state, which the reference jits on its own.
//
// What bounds it here: latency.  A window is at most 64 samples (~7 at
// 200 Hz and 30 fps): ~2 KB in, ~1.2 KB out, ~3e3 flops a sample, each
// sample's covariance and Jacobians depending on the one before.
//
// Design: one warp, no block barrier.
// - Load once: the (n, 8) sample table goes to shared memory in one
//   coalesced pass (float4 a lane), and a warp ballot compacts the valid
//   rows in their order, so padding anywhere in the table costs nothing.
// - What does not depend on the running state is computed for every
//   sample at once, a sample a lane: the bias-corrected rates, the step
//   rotation exp(w dt) (quaternion and matrix) and Jr = Jl(-w dt).
// - The rotation chain ΔR, with ΔV and ΔP, runs in every lane alike (a
//   quaternion product and a few 3-vectors a sample); the lane that owns
//   a sample keeps its ΔR, and after the chain forms, for its samples, R,
//   R [a]x and A's and B's dense rows into shared memory.
// - The covariance walks the samples with A's block structure
//   (A = [[Rkᵀ,0,0],[-R[a]x dt, I, 0],[-½R[a]x dt², I dt, I]]): lane
//   (row i, column block c) forms row i of T = A Σ from the three dense
//   columns and the two identity blocks and writes Σ' = T Aᵀ + B Sn Bᵀ/dt
//   for its three entries; beside it the 45 Jacobian entries, the five
//   Jacobians' updates in one branch-free form (no divergent paths).
//   Σ and the Jacobians ping-pong between two shared buffers: one
//   __syncwarp a sample.
// - The merge is the same block update with A = [[Rbᵀ,0,0],[0,I,0],
//   [0, I Δt, I]] plus the window's Σ; the prediction runs in every lane
//   from the frame window.
// Everything stays float32, as the reference integrates, and dt is summed
// in sample order (the host mirrors that sum exactly).
#include "lie.cuh"

namespace {

constexpr int CAP = 64;  // rows of a frame's sample table
constexpr int P = 143;   // packed Preintegrated (preintegration.py::pack)
constexpr int O_DR = 0, O_DV = 4, O_DP = 7, O_J = 10, O_COV = 55,
              O_DT = 136, O_BG = 137, O_BA = 140;
// bias Jacobians in packed order: JRg, JVg, JVa, JPg, JPa
constexpr int J_RG = 0, J_VG = 1, J_VA = 2, J_PG = 3, J_PA = 4;
// the output: window, merged window, predicted T_cw (7) and velocity (3)
constexpr int O_MERGED = P, O_POSE = 2 * P, O_VEL = 2 * P + 7;
constexpr float GRAVITY = 9.81f;

struct Shared {
    float4 tab[CAP * 2];  // the sample table, 8 floats a row
    float since[P];
    int order[CAP];       // valid rows, in order
    float dt[CAP], inv_dt[CAP];
    float a[CAP][3];      // bias-corrected accelerations
    float dq[CAP][4];     // exp(w dt)
    float Rk[CAP][9];     // its matrix
    float Jr[CAP][9];     // Jl(-w dt)
    float R[CAP][9];      // ΔR before the sample
    float RA[CAP][9];     // R [a]x
    // A's first block column, rows [Rkᵀ; -R[a]x dt; -½ R[a]x dt²], and
    // B's non-zero columns, rows [Jr dt; R dt; ½ R dt²] (9 x 3 each)
    float Acol[CAP][27];
    float Bn[CAP][27];
    float qk[CAP][4];     // ΔR before the sample
    float mAcol[27];      // the merge's: [Rbᵀ; 0; 0]
    float mR[2][9];       // the merge's Ra (keyframe window), Rb (frame)
    float cov[2][81];
    float jac[2][45];
};

// Row i, column block cb of one block update Σ' = A Σ Aᵀ + add with
// A = [[Q, 0, 0], [M, I, 0], [Nn, h I, I]] (3x3 blocks; ``Acol`` = [Q; M;
// Nn], 9 x 3 row-major): lane (i, cb) forms row i of A Σ from three dense
// columns and the identity blocks and writes Σ'[i][3 cb .. 3 cb + 2].
__device__ __forceinline__ void block_update(const float* Acol, float h,
                                             const float* S, int i, int cb,
                                             const float add[3],
                                             float* out) {
    const int bi = i / 3, ii = i % 3;
    const float a0 = Acol[3 * i], a1 = Acol[3 * i + 1], a2 = Acol[3 * i + 2];
    const float cv = bi == 0 ? 0.0f : bi == 1 ? 1.0f : h;
    const float cp = bi == 2 ? 1.0f : 0.0f;
    float t[9];  // row i of A Σ
#pragma unroll
    for (int c = 0; c < 9; ++c) {
        t[c] = a0 * S[c] + a1 * S[9 + c] + a2 * S[18 + c] +
               cv * S[9 * (3 + ii) + c] + cp * S[9 * (6 + ii) + c];
    }
    const float dv = cb == 0 ? 0.0f : cb == 1 ? 1.0f : h;
    const float dp = cb == 2 ? 1.0f : 0.0f;
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
        const float* Aj = Acol + 3 * (3 * cb + jj);
        const float v = t[0] * Aj[0] + t[1] * Aj[1] + t[2] * Aj[2] +
                        dv * t[3 + jj] + dp * t[6 + jj];
        out[9 * i + 3 * cb + jj] = v + add[jj];
    }
}

__global__ void __launch_bounds__(32)
preint_kernel(const float* __restrict__ since,
              const float* __restrict__ samples, int n,
              const float* __restrict__ bias_g,
              const float* __restrict__ bias_a, float ng2, float na2,
              const float* __restrict__ T_cw, const float* __restrict__ vel,
              const float* __restrict__ T_bc, float* __restrict__ out) {
    __shared__ Shared sh;
    const int lane = threadIdx.x;

    // ---- load once: the table and the keyframe window, every load in
    // flight before the first store
    const float4* rows4 = reinterpret_cast<const float4*>(samples);
    float4 t4[4];
    float sv[5];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int i = lane + 32 * u;
        t4[u] = i < 2 * n ? rows4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 5; ++u) {
        const int i = lane + 32 * u;
        sv[u] = i < P ? since[i] : 0.0f;
    }
    float bg[3], ba[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        bg[i] = bias_g[i];
        ba[i] = bias_a[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sh.tab[lane + 32 * u] = t4[u];
#pragma unroll
    for (int u = 0; u < 5; ++u) {
        if (lane + 32 * u < P) sh.since[lane + 32 * u] = sv[u];
    }
    __syncwarp();
    int nv = 0;
    for (int half = 0; half < CAP; half += 32) {
        const int r = half + lane;
        const bool ok = r < n && sh.tab[2 * r + 1].w != 0.0f;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        if (ok) sh.order[nv + __popc(m & ((1u << lane) - 1u))] = r;
        nv += __popc(m);
    }
    __syncwarp();

    // ---- per sample, a sample a lane: what the running state does not
    // change
    for (int k = lane; k < nv; k += 32) {
        const float4 lo = sh.tab[2 * sh.order[k]];
        const float4 hi = sh.tab[2 * sh.order[k] + 1];
        const float dtv = hi.z;
        const float w[3] = {lo.x - bg[0], lo.y - bg[1], lo.z - bg[2]};
        sh.a[k][0] = lo.w - ba[0];
        sh.a[k][1] = hi.x - ba[1];
        sh.a[k][2] = hi.y - ba[2];
        sh.dt[k] = dtv;
        float wdt[3], mwdt[3];
        for (int i = 0; i < 3; ++i) {
            wdt[i] = w[i] * dtv;
            mwdt[i] = -w[i] * dtv;
        }
        float dq[4], Rk[9], Jr[9];
        so3_exp(wdt, dq);
        quat_to_mat(dq, Rk);
        so3_left_jac(mwdt, Jr);
        for (int i = 0; i < 4; ++i) sh.dq[k][i] = dq[i];
        for (int i = 0; i < 9; ++i) {
            sh.Rk[k][i] = Rk[i];
            sh.Jr[k][i] = Jr[i];
            sh.Acol[k][i] = Rk[3 * (i % 3) + i / 3];  // Rkᵀ
            sh.Bn[k][i] = Jr[i] * dtv;
        }
        sh.inv_dt[k] = dtv > 0.0f ? 1.0f / fmaxf(dtv, 1e-9f) : 0.0f;
    }
    for (int i = lane; i < 81; i += 32) sh.cov[0][i] = 0.0f;
    for (int i = lane; i < 45; i += 32) sh.jac[0][i] = 0.0f;
    __syncwarp();

    // ---- the rotation chain with ΔV and ΔP, in every lane; the lane
    // that owns a sample keeps its ΔR
    float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
    float dV[3] = {0.0f, 0.0f, 0.0f}, dP[3] = {0.0f, 0.0f, 0.0f};
    float dts = 0.0f;
    for (int k = 0; k < nv; ++k) {
        const float dtv = sh.dt[k];
        const float* a = sh.a[k];
        float R[9];
        quat_to_mat(q, R);
        float Ra[3];
        for (int i = 0; i < 3; ++i) {
            Ra[i] = R[3 * i] * a[0] + R[3 * i + 1] * a[1] + R[3 * i + 2] * a[2];
        }
        for (int i = 0; i < 3; ++i) {
            dP[i] = dP[i] + dV[i] * dtv + 0.5f * Ra[i] * dtv * dtv;
            dV[i] = dV[i] + Ra[i] * dtv;
        }
        if (lane == (k & 31)) {
            for (int i = 0; i < 4; ++i) sh.qk[k][i] = q[i];
        }
        float qn[4];
        quat_mul(q, sh.dq[k], qn);
        quat_normalize(qn);
        for (int i = 0; i < 4; ++i) q[i] = qn[i];
        dts = dts + dtv;
    }

    // ---- per sample, a sample a lane: R, R [a]x and A's and B's
    // remaining rows (the lane that kept the sample's ΔR)
    for (int k = lane; k < nv; k += 32) {
        const float dtv = sh.dt[k];
        const float* a = sh.a[k];
        float R[9], RA[9];
        quat_to_mat(sh.qk[k], R);
        const float ahat[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0],
                               -a[1], a[0], 0.0f};
        mat3_mul(R, ahat, RA);
        for (int i = 0; i < 9; ++i) {
            sh.R[k][i] = R[i];
            sh.RA[k][i] = RA[i];
            sh.Acol[k][9 + i] = -RA[i] * dtv;
            sh.Acol[k][18 + i] = -0.5f * RA[i] * dtv * dtv;
            sh.Bn[k][9 + i] = R[i] * dtv;
            sh.Bn[k][18 + i] = 0.5f * R[i] * dtv * dtv;
        }
    }
    __syncwarp();

    // ---- covariance and bias Jacobians, sample by sample
    const int ci = lane / 3, cb = lane % 3;  // lanes 0-26: row, block
    int cur = 0;
    for (int k = 0; k < nv; ++k) {
        const float dtv = sh.dt[k];
        const float* S = sh.cov[cur];
        const float* J = sh.jac[cur];
        if (lane < 27) {
            // B Sn Bᵀ / dt: the gyro rows (block r) with ng2, the
            // accelerometer rows (blocks v, p) with na2
            const float* Bn = sh.Bn[k];
            const int bi = ci / 3;
            const float inv_dt = sh.inv_dt[k];
            float add[3];
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
                const int j = 3 * cb + jj;
                const float sn = bi == 0 ? ng2 : na2;
                float nz = 0.0f;
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    nz += Bn[3 * ci + m] * sn * Bn[3 * j + m];
                }
                add[jj] = (bi == 0) == (cb == 0) ? nz * inv_dt : 0.0f;
            }
            block_update(sh.Acol[k], dtv, S, ci, cb, add, sh.cov[cur ^ 1]);
        }
        // the five Jacobians in one branch-free form: JRg' = Rkᵀ JRg -
        // Jr dt, JVg' = JVg - R[a]x JRg dt, JVa' = JVa - R dt, JPg' = JPg +
        // JVg dt - ½ R[a]x JRg dt², JPa' = JPa + JVa dt - ½ R dt²
        for (int e_all = lane; e_all < 45; e_all += 32) {
            const int m = e_all / 9, e = e_all % 9, r = e / 3, c = e % 3;
            const bool rg = m == J_RG;
            const float* W = rg ? sh.Rk[k] : sh.RA[k];
            float prod = 0.0f;  // (Rkᵀ JRg)[r][c] or (R [a]x JRg)[r][c]
#pragma unroll
            for (int qq = 0; qq < 3; ++qq) {
                prod += W[rg ? 3 * qq + r : 3 * r + qq] *
                        J[9 * J_RG + 3 * qq + c];
            }
            const float hdt2 = 0.5f * dtv * dtv;
            const float cprod = rg ? 1.0f : m == J_VG ? -dtv
                                : m == J_PG ? -hdt2 : 0.0f;
            const float x = rg ? sh.Jr[k][e] : sh.R[k][e];
            const float cx = rg || m == J_VA ? -dtv : m == J_PA ? -hdt2
                                                               : 0.0f;
            const float self = rg ? 0.0f : J[9 * m + e];
            const float aux = m == J_PG   ? J[9 * J_VG + e]
                              : m == J_PA ? J[9 * J_VA + e]
                                          : 0.0f;
            sh.jac[cur ^ 1][e_all] = self + aux * dtv + prod * cprod + x * cx;
        }
        cur ^= 1;
        __syncwarp();
    }
    const float* Sb = sh.cov[cur];
    const float* Jb = sh.jac[cur];

    // ---- the window
    float* win = out;
    if (lane == 0) {  // static indices: q, dV, dP stay in registers
        for (int i = 0; i < 4; ++i) win[O_DR + i] = q[i];
        for (int i = 0; i < 3; ++i) {
            win[O_DV + i] = dV[i];
            win[O_DP + i] = dP[i];
            win[O_BG + i] = bg[i];
            win[O_BA + i] = ba[i];
        }
        win[O_DT] = dts;
    }
    for (int i = lane; i < 45; i += 32) win[O_J + i] = Jb[i];
    for (int i = lane; i < 81; i += 32) win[O_COV + i] = Sb[i];

    // ---- merge(since, window): ΔP, ΔV, ΔR, the Jacobians to first order,
    // A Σ_a Aᵀ + Σ_b
    const float* A = sh.since;
    float* mg = out + O_MERGED;
    float Ra[9], Rb[9];
    quat_to_mat(A + O_DR, Ra);
    quat_to_mat(q, Rb);
    if (lane == 0) {
        for (int i = 0; i < 9; ++i) {
            sh.mR[0][i] = Ra[i];
            sh.mR[1][i] = Rb[i];
        }
        for (int i = 0; i < 3; ++i) {
            float rp = 0.0f, rv = 0.0f;
            for (int m = 0; m < 3; ++m) {
                rp += Ra[3 * i + m] * dP[m];
                rv += Ra[3 * i + m] * dV[m];
            }
            mg[O_DP + i] = A[O_DP + i] + A[O_DV + i] * dts + rp;
            mg[O_DV + i] = A[O_DV + i] + rv;
            mg[O_BG + i] = A[O_BG + i];
            mg[O_BA + i] = A[O_BA + i];
        }
        float qm[4];
        quat_mul(A + O_DR, q, qm);
        quat_normalize(qm);
        for (int i = 0; i < 4; ++i) mg[O_DR + i] = qm[i];
        mg[O_DT] = A[O_DT] + dts;
    }
    __syncwarp();
    // JRg = Rbᵀ JRg_a + JRg_b; J = J_a (+ J_a' Δt for JPg, JPa) + Ra J_b
    const float* Ja = A + O_J;
    for (int e_all = lane; e_all < 45; e_all += 32) {
        const int m = e_all / 9, e = e_all % 9, r = e / 3, c = e % 3;
        const bool rg = m == J_RG;
        const float* W = sh.mR[rg ? 1 : 0];
        const float* src = rg ? Ja : Jb + 9 * m;
        float prod = 0.0f;
#pragma unroll
        for (int qq = 0; qq < 3; ++qq) {
            prod += W[rg ? 3 * qq + r : 3 * r + qq] * src[3 * qq + c];
        }
        const float base = rg ? Jb[e] : Ja[9 * m + e];
        const float aux = m == J_PG   ? Ja[9 * J_VG + e]
                          : m == J_PA ? Ja[9 * J_VA + e]
                                      : 0.0f;
        mg[O_J + e_all] = base + aux * dts + prod;
    }
    if (lane < 27) {
        sh.mAcol[lane] = lane < 9 ? sh.mR[1][3 * (lane % 3) + lane / 3]
                                  : 0.0f;
    }
    __syncwarp();
    if (lane < 27) {
        const float add[3] = {Sb[9 * ci + 3 * cb], Sb[9 * ci + 3 * cb + 1],
                              Sb[9 * ci + 3 * cb + 2]};
        block_update(sh.mAcol, dts, A + O_COV, ci, cb, add, mg + O_COV);
    }

    // ---- the dead-reckoned pose and velocity from the frame window
    // (predict_state): p_j = p_i + v Δt + ½ g Δt² + R_wb ΔP, v_j = v + g Δt
    // + R_wb ΔV, q_wb_j = q_wb ΔR
    if (T_cw == nullptr || lane != 0) return;
    float Tbi[7], Twb[7];
    se3_mul(T_bc, T_cw, Tbi);
    se3_inv(Tbi, Twb);
    float Rwb[9];
    quat_to_mat(Twb, Rwb);
    const float g[3] = {0.0f, 0.0f, -GRAVITY};
    float Tj[7];
    for (int i = 0; i < 3; ++i) {
        float rp = 0.0f, rv = 0.0f;
        for (int m = 0; m < 3; ++m) {
            rp += Rwb[3 * i + m] * dP[m];
            rv += Rwb[3 * i + m] * dV[m];
        }
        Tj[4 + i] = Twb[4 + i] + vel[i] * dts + 0.5f * g[i] * dts * dts + rp;
        out[O_VEL + i] = vel[i] + g[i] * dts + rv;
    }
    quat_mul(Twb, q, Tj);
    quat_normalize(Tj);
    float Tjinv[7], Tcb[7], Tc[7];
    se3_inv(Tj, Tjinv);
    se3_inv(T_bc, Tcb);
    se3_mul(Tcb, Tjinv, Tc);
    quat_normalize(Tc);
    for (int i = 0; i < 7; ++i) out[O_POSE + i] = Tc[i];
}

}  // namespace

// since: (143,) f32 packed keyframe window; samples: (n, 8) f32
// [wx wy wz ax ay az dt valid], n <= 64, 16-byte aligned; bias_g / bias_a:
// (3,) f32, the linearisation biases; ng2 / na2: the noise densities
// squared; T_cw (7,), vel (3,), T_bc (7,): the last frame's pose and
// velocity and the body-camera transform, or T_cw null for no prediction.
// Writes out (296,): the window (143), merge(since, window) (143) and,
// given T_cw, the predicted T_cw (7) and velocity (3).
VSG_API int vsg_preint(const float* since, const float* samples, int n,
                       const float* bias_g, const float* bias_a, float ng2,
                       float na2, const float* T_cw, const float* vel,
                       const float* T_bc, float* out, cudaStream_t stream) {
    if (n < 0 || n > CAP) return (int)cudaErrorInvalidValue;
    preint_kernel<<<1, 32, 0, stream>>>(since, samples, n, bias_g, bias_a,
                                        ng2, na2, T_cw, vel, T_bc, out);
    return (int)cudaGetLastError();
}
