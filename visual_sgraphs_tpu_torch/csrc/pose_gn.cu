// K6: motion-only Gauss-Newton pose solve (IRLS Huber + chi2 gate
// schedule, RGB-D stereo row), the whole iteration schedule in one launch.
//
// Replaces visual_sgraphs_tpu/slam/tracking.py::pose_only_gn.  The JAX
// version is a lax.scan of 12 steps, each building (M, 3, 6) Jacobians,
// a (6, 3M) x (3M, 6) matmul and a 6x6 solve as separate XLA ops.
//
// What bounds it here: launch and synchronisation latency, not flops or
// bytes — M <= 4096 matches is ~100 KB of input and ~1 MFLOP per
// iteration.  Run as separate ops, 12 iterations cost ~150 launches.
//
// Design: one block per solve keeps the pose in shared memory and loops
// over the schedule inside the kernel (wide gate for the first
// max(iters/4, 1) iterations when gate0 > final_gate).  Each iteration
// every thread accumulates its matches' 21 upper-triangular J^T W J
// entries and 6 J^T W r entries in fp32 registers, a warp-shuffle + shared
// memory reduction sums them, and one thread solves the damped 6x6
// system by Cholesky in registers, guards non-finite steps, and applies
// exp(dx) * T with renormalisation.  With a pose prior (the inertial
// path's dead-reckoned prediction, tracking.py:183-187) that thread adds
// w I to H and w log(T T_prior^-1) to g first: the reference's J = I
// approximation of the prior's Jacobian, mirrored exactly.  The final 2-dof inlier test runs at
// the solution.  Sums are taken in another order than the plain PyTorch
// version, so poses agree to a tolerance, not bitwise.
#include "lie.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int NACC = 27;  // 21 upper-triangular H + 6 g

struct Pose {
    float q[4];
    float t[3];
};

__device__ void quat_to_rot(const float* q, float R[9]) {
    const float w = q[0], x = q[1], y = q[2], z = q[3];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz); R[2] = 2 * (xz + wy);
    R[3] = 2 * (xy + wz); R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
    R[6] = 2 * (xz - wy); R[7] = 2 * (yz + wx); R[8] = 1 - 2 * (xx + yy);
}

__device__ void quat_rotate(const float* q, const float* v, float* out) {
    // v + w * uv + qvec x uv, uv = 2 qvec x v (core/lie.py::quat_rotate)
    const float* u = q + 1;
    float uv[3] = {2.0f * (u[1] * v[2] - u[2] * v[1]),
                   2.0f * (u[2] * v[0] - u[0] * v[2]),
                   2.0f * (u[0] * v[1] - u[1] * v[0])};
    out[0] = v[0] + q[0] * uv[0] + (u[1] * uv[2] - u[2] * uv[1]);
    out[1] = v[1] + q[0] * uv[1] + (u[2] * uv[0] - u[0] * uv[2]);
    out[2] = v[2] + q[0] * uv[2] + (u[0] * uv[1] - u[1] * uv[0]);
}

// exp([rho, omega]) * T, then quaternion renormalisation
// (lie.se3_normalize(lie.se3_boxplus(T, dx))).
__device__ void boxplus_normalize(Pose& T, const float dx[6]) {
    const float* rho = dx;
    const float* om = dx + 3;
    const float th2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
    const bool small = th2 < 1e-8f;
    const float th = sqrtf(small ? 1.0f : th2);
    const float half = 0.5f * th;
    const float k = small ? 0.5f - th2 / 48.0f : sinf(half) / th;
    const float qw = small ? 1.0f - th2 / 8.0f : cosf(half);
    float qe[4] = {qw, k * om[0], k * om[1], k * om[2]};
    const float n2 = qe[0] * qe[0] + qe[1] * qe[1] + qe[2] * qe[2] +
                     qe[3] * qe[3];
    const float inv_n = sqrtf(1.0f / fmaxf(n2, 1.17549435e-38f));
    for (int i = 0; i < 4; ++i) qe[i] *= inv_n;
    // V = I + a W + b W^2
    const float s2 = small ? 1.0f : th2;
    const float a = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / s2;
    const float b = small ? 1.0f / 6.0f - th2 / 120.0f
                          : (th - sinf(th)) / (small ? 1.0f : th2 * th);
    float Wr[3] = {om[1] * rho[2] - om[2] * rho[1],
                   om[2] * rho[0] - om[0] * rho[2],
                   om[0] * rho[1] - om[1] * rho[0]};
    float WWr[3] = {om[1] * Wr[2] - om[2] * Wr[1],
                    om[2] * Wr[0] - om[0] * Wr[2],
                    om[0] * Wr[1] - om[1] * Wr[0]};
    float te[3];
    for (int i = 0; i < 3; ++i) te[i] = rho[i] + a * Wr[i] + b * WWr[i];
    // (qe, te) * (T.q, T.t)
    const float* p = T.q;
    float q[4] = {
        qe[0] * p[0] - qe[1] * p[1] - qe[2] * p[2] - qe[3] * p[3],
        qe[0] * p[1] + qe[1] * p[0] + qe[2] * p[3] - qe[3] * p[2],
        qe[0] * p[2] - qe[1] * p[3] + qe[2] * p[0] + qe[3] * p[1],
        qe[0] * p[3] + qe[1] * p[2] - qe[2] * p[1] + qe[3] * p[0]};
    float rt[3];
    quat_rotate(qe, T.t, rt);
    const float m2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
    const float inv_m = sqrtf(1.0f / fmaxf(m2, 1.17549435e-38f));
    for (int i = 0; i < 4; ++i) T.q[i] = q[i] * inv_m;
    for (int i = 0; i < 3; ++i) T.t[i] = rt[i] + te[i];
}

// Solve (H + 1e-3 I) dx = -g by Cholesky; H given as 21 upper entries.
__device__ void solve6(const float* acc, float dx[6]) {
    float A[6][6];
    int k = 0;
    for (int i = 0; i < 6; ++i) {
        for (int j = i; j < 6; ++j) {
            A[i][j] = acc[k];
            A[j][i] = acc[k];
            ++k;
        }
    }
    for (int i = 0; i < 6; ++i) A[i][i] += 1e-3f;
    float L[6][6] = {};
    for (int j = 0; j < 6; ++j) {
        float s = A[j][j];
        for (int p = 0; p < j; ++p) s -= L[j][p] * L[j][p];
        const float d = sqrtf(s);
        L[j][j] = d;
        for (int i = j + 1; i < 6; ++i) {
            float t = A[i][j];
            for (int p = 0; p < j; ++p) t -= L[i][p] * L[j][p];
            L[i][j] = t / d;
        }
    }
    float y[6];
    for (int i = 0; i < 6; ++i) {
        float s = -acc[21 + i];
        for (int p = 0; p < i; ++p) s -= L[i][p] * y[p];
        y[i] = s / L[i][i];
    }
    for (int i = 5; i >= 0; --i) {
        float s = y[i];
        for (int p = i + 1; p < 6; ++p) s -= L[p][i] * dx[p];
        dx[i] = s / L[i][i];
    }
    for (int i = 0; i < 6; ++i) dx[i] = isfinite(dx[i]) ? dx[i] : 0.0f;
}

__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(const float* __restrict__ T_init, const float* __restrict__ xw,
               const float* __restrict__ uv,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ cam, const float* __restrict__ depth,
               const float* __restrict__ bf_ptr, int n, int iters,
               int n_wide, float gate0, float final_gate, float huber,
               float chi2_gate, const float* __restrict__ T_prior,
               float prior_weight, float* __restrict__ T_out,
               uint8_t* __restrict__ inliers) {
    __shared__ Pose sT;
    __shared__ float red[NWARP][NACC];
    __shared__ float tot[NACC];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    if (tid == 0) {
        for (int i = 0; i < 4; ++i) sT.q[i] = T_init[i];
        for (int i = 0; i < 3; ++i) sT.t[i] = T_init[4 + i];
    }
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    const bool stereo = depth != nullptr;
    const float bf = stereo ? bf_ptr[0] : 0.0f;
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        const float gate = it < n_wide ? gate0 : final_gate;
        float R[9];
        quat_to_rot(sT.q, R);
        const float t0 = sT.t[0], t1 = sT.t[1], t2 = sT.t[2];
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
        for (int m = tid; m < n; m += THREADS) {
            const float X = xw[3 * m], Y = xw[3 * m + 1], Z = xw[3 * m + 2];
            const float px = R[0] * X + R[1] * Y + R[2] * Z + t0;
            const float py = R[3] * X + R[4] * Y + R[5] * Z + t1;
            const float pz = R[6] * X + R[7] * Y + R[8] * Z + t2;
            const float z = fmaxf(pz, 1e-6f);
            const float iz = 1.0f / z;
            const float u_hat = fx * px * iz + cx;
            const float v_hat = fy * py * iz + cy;
            const bool vm = valid[m] != 0;
            const float r0 = u_hat - uv[2 * m];
            const float r1 = v_hat - uv[2 * m + 1];
            float r2 = 0.0f;
            float s3 = 0.0f;  // has_d * w_ur
            if (stereo) {
                const float dm = depth[m];
                const bool has_d = vm && dm > 0.0f;
                const float q = 2.5f / fmaxf(dm, 0.1f);
                const float w_ur = fminf(1.0f, q * q);
                if (has_d) {
                    const float ur_obs = uv[2 * m] - bf / dm;
                    r2 = ((u_hat - bf * iz) - ur_obs) * w_ur;
                    s3 = w_ur;
                }
            }
            const float chi2 = r0 * r0 + r1 * r1 + r2 * r2;
            const bool ok = vm && pz > 0.05f && chi2 <= gate;
            if (!ok) continue;
            const float s = sqrtf(fmaxf(chi2, 1e-12f));
            const float w = fminf(1.0f, huber / s);
            // rows of d(residual)/d(p), then J = Jp [I | -hat(p)]
            const float iz2 = iz * iz;
            const float rows[3][3] = {
                {fx * iz, 0.0f, -fx * px * iz2},
                {0.0f, fy * iz, -fy * py * iz2},
                {fx * iz * s3, 0.0f, (-fx * px + bf) * iz2 * s3}};
            const float res[3] = {r0, r1, r2};
            const int nrow = stereo ? 3 : 2;
            for (int rr = 0; rr < nrow; ++rr) {
                const float a0 = rows[rr][0], a1 = rows[rr][1],
                            a2 = rows[rr][2];
                const float J[6] = {a0, a1, a2,
                                    -a1 * pz + a2 * py,
                                    a0 * pz - a2 * px,
                                    -a0 * py + a1 * px};
                int k = 0;
#pragma unroll
                for (int i = 0; i < 6; ++i) {
                    const float wj = w * J[i];
#pragma unroll
                    for (int j = i; j < 6; ++j) acc[k++] += wj * J[j];
                }
#pragma unroll
                for (int i = 0; i < 6; ++i) acc[21 + i] += w * J[i] * res[rr];
            }
        }
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
            const float v = vsg_warp_sum(acc[k]);
            if (lane == 0) red[warp][k] = v;
        }
        __syncthreads();
        if (tid < NACC) {
            float s = 0.0f;
            for (int wi = 0; wi < NWARP; ++wi) s += red[wi][tid];
            tot[tid] = s;
        }
        __syncthreads();
        if (tid == 0) {
            if (T_prior != nullptr) {
                // r_p = log(T T_prior^-1); H += w I, g += w r_p
                float Tc[7], Pi[7], D[7], rp[6];
                for (int i = 0; i < 4; ++i) Tc[i] = sT.q[i];
                for (int i = 0; i < 3; ++i) Tc[4 + i] = sT.t[i];
                float Tp[7];
                for (int i = 0; i < 7; ++i) Tp[i] = T_prior[i];
                se3_inv(Tp, Pi);
                se3_mul(Tc, Pi, D);
                se3_log(D, rp);
                constexpr int DIAG[6] = {0, 6, 11, 15, 18, 20};
                for (int i = 0; i < 6; ++i) {
                    tot[DIAG[i]] += prior_weight;
                    tot[21 + i] += prior_weight * rp[i];
                }
            }
            float dx[6];
            solve6(tot, dx);
            boxplus_normalize(sT, dx);
        }
        __syncthreads();
    }

    const Pose T = sT;
    for (int m = tid; m < n; m += THREADS) {
        const float v[3] = {xw[3 * m], xw[3 * m + 1], xw[3 * m + 2]};
        float p[3];
        quat_rotate(T.q, v, p);
        p[0] += T.t[0];
        p[1] += T.t[1];
        p[2] += T.t[2];
        const float zz = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
        const float iz = 1.0f / zz;
        const float du = fx * p[0] * iz + cx - uv[2 * m];
        const float dv = fy * p[1] * iz + cy - uv[2 * m + 1];
        const float chi2 = du * du + dv * dv;
        inliers[m] = (valid[m] != 0 && p[2] > 0.05f && chi2 <= chi2_gate)
                         ? 1 : 0;
    }
    if (tid == 0) {
        for (int i = 0; i < 4; ++i) T_out[i] = T.q[i];
        for (int i = 0; i < 3; ++i) T_out[4 + i] = T.t[i];
    }
}

}  // namespace

// T_init: (7,) f32; xw: (n, 3); uv: (n, 2); valid: (n,) u8; cam: (4,)
// [fx, fy, cx, cy]; depth: (n,) f32 or NULL (no stereo row); bf_ptr: ()
// f32 (read only with depth); T_prior: (7,) f32 or NULL (no prior),
// weighted by prior_weight.  Writes T_out (7,) and inliers (n,) u8.
VSG_API int vsg_pose_gn(const float* T_init, const float* xw, const float* uv,
                        const uint8_t* valid, const float* cam,
                        const float* depth, const float* bf_ptr, int n,
                        int iters, int n_wide, float gate0, float final_gate,
                        float huber, float chi2_gate, const float* T_prior,
                        float prior_weight, float* T_out, uint8_t* inliers,
                        cudaStream_t stream) {
    pose_gn_kernel<<<1, THREADS, 0, stream>>>(
        T_init, xw, uv, valid, cam, depth, bf_ptr, n, iters, n_wide, gate0,
        final_gate, huber, chi2_gate, T_prior, prior_weight, T_out,
        inliers);
    return (int)cudaGetLastError();
}
