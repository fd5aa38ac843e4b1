// The preintegration residual of the port's inertial kernels (K20's
// per-frame solve, K22b's local-BA and initialisation rows), templated
// over the scalar (float / Dual / DualD, see lie.cuh).
//
// inertial/factors.py::_imu_residual (Forster et al. eq. 37-39) on a
// packed preintegration (inertial/preintegration.py::pack), with every
// variable free: pose_i, pose_j (camera poses T_cw, through the extrinsic
// T_bc), vel_i, vel_j, the biases, the world gravity g_w and the scale s,
// whitened by a 9x9 sqrt information W.
#pragma once

#include "lie.cuh"

namespace imu {

constexpr int P = 143;  // packed Preintegrated (preintegration.py::pack)
constexpr int O_DR = 0, O_DV = 4, O_DP = 7, O_J = 10, O_COV = 55,
              O_DT = 136, O_BG = 137, O_BA = 140;
constexpr int J_RG = 0, J_VG = 1, J_VA = 2, J_PG = 3, J_PA = 4;
constexpr float GRAVITY = 9.81f;

// (R_wb, p_wb) of a camera pose T_cw through the extrinsic T_bc
template <typename T>
__device__ void body_state(const T* T_cw, const T* T_bc, T* R, T* p) {
    T T_bw[7], T_wb[7];
    se3_mul(T_bc, T_cw, T_bw);
    se3_inv(T_bw, T_wb);
    quat_to_mat(T_wb, R);
    for (int i = 0; i < 3; ++i) p[i] = T_wb[4 + i];
}

template <typename T>
__device__ void mat3_vec(const float* M, const T* v, T* out) {
    for (int i = 0; i < 3; ++i) {
        out[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
    }
}

// r = W [r_R, r_V, r_P] at (Ti, Tj, vi, vj, bg, ba, g_w, s); ``pre`` the
// packed preintegration, ``W`` (81, row-major) its sqrt information
// the residual from the bodies' states (R_wb, p_wb) of frames i and j
template <typename T, typename WT>
__device__ void residual_body(const float* pre, const WT* W, const T* Ri,
                              const T* pi, const T* Rj, const T* pj,
                              const T* vi, const T* vj, const T* bg,
                              const T* ba, const T* g, T s, T* r) {
    const float dt = pre[O_DT];
    T dbg[3], dba[3];
    for (int i = 0; i < 3; ++i) {
        dbg[i] = bg[i] - pre[O_BG + i];
        dba[i] = ba[i] - pre[O_BA + i];
    }
    T w[3], e[4], dRc[4], dR[4];
    mat3_vec(pre + O_J + 9 * J_RG, dbg, w);
    so3_exp(w, e);
    for (int i = 0; i < 4; ++i) dRc[i] = cst<T>(pre[O_DR + i]);
    quat_mul(dRc, e, dR);
    T jvg[3], jva[3], jpg[3], jpa[3], dV[3], dP[3];
    mat3_vec(pre + O_J + 9 * J_VG, dbg, jvg);
    mat3_vec(pre + O_J + 9 * J_VA, dba, jva);
    mat3_vec(pre + O_J + 9 * J_PG, dbg, jpg);
    mat3_vec(pre + O_J + 9 * J_PA, dba, jpa);
    for (int i = 0; i < 3; ++i) {
        dV[i] = pre[O_DV + i] + jvg[i] + jva[i];
        dP[i] = pre[O_DP + i] + jpg[i] + jpa[i];
    }
    T RiT[9], M[9], qm[4], dRi[4], qe[4];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) RiT[3 * i + j] = Ri[3 * j + i];
    }
    mat3_mul(RiT, Rj, M);
    mat_to_quat(M, qm);
    dRi[0] = dR[0];
    for (int i = 1; i < 4; ++i) dRi[i] = -dR[i];
    quat_mul(dRi, qm, qe);
    T r9[9];
    so3_log(qe, r9);
    T a[3], b[3];
    for (int i = 0; i < 3; ++i) {
        a[i] = s * (vj[i] - vi[i]) - g[i] * dt;
        b[i] = s * (pj[i] - pi[i] - vi[i] * dt) - 0.5f * g[i] * dt * dt;
    }
    for (int i = 0; i < 3; ++i) {
        r9[3 + i] = RiT[3 * i] * a[0] + RiT[3 * i + 1] * a[1] +
                    RiT[3 * i + 2] * a[2] - dV[i];
        r9[6 + i] = RiT[3 * i] * b[0] + RiT[3 * i + 1] * b[1] +
                    RiT[3 * i + 2] * b[2] - dP[i];
    }
    for (int i = 0; i < 9; ++i) {
        T acc = cst<T>(0.0f);
        for (int k = 0; k < 9; ++k) acc = acc + W[9 * i + k] * r9[k];
        r[i] = acc;
    }
}

template <typename T, typename WT>
__device__ void residual(const float* pre, const WT* W, const T* Ti,
                         const T* Tj, const T* vi, const T* vj, const T* bg,
                         const T* ba, const T* g, T s, const T* Tbc, T* r) {
    T Ri[9], pi[3], Rj[9], pj[3];
    body_state(Ti, Tbc, Ri, pi);
    body_state(Tj, Tbc, Rj, pj);
    residual_body(pre, W, Ri, pi, Rj, pj, vi, vj, bg, ba, g, s, r);
}

// W = L^-1 for L L^T = cov + 1e-8 I, its lower triangle read as torch's
// Cholesky reads it (inertial/init.py::sqrt_info), in float64, on one
// warp (every lane calls): lane i < 9 holds row i of L, built column by
// column, then column i of W by forward substitution, returned in ``Wc``
// (lanes past 8 repeat lane 8).  Returns, on every lane, whether all of W
// is finite (where not, the caller takes the identity).  The 1e-8 is
// added in float64, as the float64 twin adds it.
__device__ inline bool sqrt_info_warp(const float* cov, int lane,
                                      double (&Wc)[9]) {
    const int i = lane < 9 ? lane : 8;
    double L[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) L[k] = 0.0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
        // row j's entries left of the diagonal, from lane j
        double Lj[9];
#pragma unroll
        for (int k = 0; k < j; ++k) Lj[k] = __shfl_sync(0xffffffffu, L[k], j);
        double s = (double)cov[9 * j + j] + 1e-8;
#pragma unroll
        for (int k = 0; k < j; ++k) s -= Lj[k] * Lj[k];
        const double d = sqrt(s);
        if (i == j) L[j] = d;
        if (i > j) {
            double t = (double)(cov[9 * i + j]);
#pragma unroll
            for (int k = 0; k < j; ++k) t -= L[k] * Lj[k];
            L[j] = t / d;
        }
    }
    // row r of L from lane r
    bool ok = true;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
        double Lr[9];
#pragma unroll
        for (int k = 0; k <= r; ++k) Lr[k] = __shfl_sync(0xffffffffu, L[k], r);
        double s = r == i ? 1.0 : 0.0;
#pragma unroll
        for (int k = 0; k < r; ++k) s -= Lr[k] * Wc[k];
        Wc[r] = s / Lr[r];
        ok = ok && isfinite(Wc[r]);
    }
    return __all_sync(0xffffffffu, ok || lane >= 9);
}

}  // namespace imu
