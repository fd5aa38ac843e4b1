// K20: the per-frame visual-inertial Gauss-Newton solve, all iterations in
// one launch.
//
// Replaces visual_sgraphs_tpu/inertial/pipeline.py::pose_inertial_gn
// (PoseInertialOptimizationLastFrame): 6 iterations over
// x = [δpose (6), δv (3), δbg (3), δba (3)] of the frame's weighted
// (u, v, u_r) reprojection rows (up to F = 1000 features), the 9 rows of
// the preintegration residual to the last frame (held fixed) and the 6
// bias-walk rows.  The JAX version builds the (3F + 15, 15) Jacobian with
// jax.jacfwd (15 forward passes) and solves the 15x15 normal equations,
// every iteration.
//
// What bounds it here: latency.  One solve reads ~60 KB (F features'
// points, pixels, depths, ids) and does ~1e6 flops; as separate PyTorch
// ops it is hundreds of launches.
//
// Design: one block per solve keeps the state (T_j, v_j, bg, ba) in shared
// memory and loops over the iterations inside the kernel.  Each iteration:
// - lanes 0-14 of warp 0 evaluate the preintegration residual
//   (imu.cuh, shared with K22b) in forward mode, one dual-number
//   direction per lane (lie.cuh's templates
//   transcribe core/lie.py branch for branch, so each lane computes the
//   column jax.jacfwd computes), into a 9x15 Jacobian in shared memory;
// - every thread walks its features: IRLS weight (Huber, 4 χ² gate) from
//   the current reprojection, the weighted rows and their analytic
//   Jacobian in the left pose perturbation, J = Jp [I | -[p]x] (only the
//   6 pose columns are non-zero), accumulated as 21 + 6 normal-equation
//   sums in float32, reduced by warp shuffles and shared memory;
// - one thread assembles the 15x15 system JᵀJ + 1e-6 I and Jᵀr in
//   float64, solves it by Gaussian elimination with partial pivoting,
//   zeroes non-finite steps and applies exp(dx) T_j (renormalised),
//   v + dx, bg + dx, ba + dx.
// The preintegration's sqrt information (the inverse of the Cholesky
// factor of cov + 1e-8 I, the identity if that is not finite) is computed
// once a solve in float64.  After the last iteration the block counts the
// inliers (2-dof χ² < 7.815).  The solve runs in float64 where the
// reference's runs in float32 (its 15x15 system spans ~17 orders of
// magnitude): the plain twin does the same, so the two agree to float32
// summation order.
#include "imu.cuh"

namespace {

using imu::GRAVITY;
using imu::O_BA;
using imu::O_BG;
using imu::O_COV;
using imu::P;

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int NACC = 27;  // 21 upper-triangular pose block + 6 gradient
constexpr float CHI2 = 7.815f;

struct Shared {
    float pre[P];
    float W[81];  // sqrt information, row-major
    float Ti[7], vi[3], Tbc[7];
    float Tj[7], vj[3], bg[3], ba[3];
    float Jimu[9][15];
    float rimu[9];
    float red[NWARP][NACC];
    float tot[NACC];
    double H[15][15];
    double g[15];
    double dx[15];
    int cnt[NWARP];
};

// inertial/factors.py::_imu_residual with T_i, v_i fixed, scale 1 and
// g = (0, 0, -9.81), whitened: W [r_R, r_V, r_P] (imu.cuh)
template <typename T>
__device__ void imu_residual(const Shared& S, const T* Tj, const T* vj,
                             const T* bg, const T* ba, T* r) {
    T Ti[7], Tbc[7], vi[3], g[3];
    for (int i = 0; i < 7; ++i) {
        Ti[i] = cst<T>(S.Ti[i]);
        Tbc[i] = cst<T>(S.Tbc[i]);
    }
    for (int i = 0; i < 3; ++i) {
        vi[i] = cst<T>(S.vi[i]);
        g[i] = cst<T>(i == 2 ? -GRAVITY : 0.0f);
    }
    imu::residual(S.pre, S.W, Ti, Tj, vi, vj, bg, ba, g, cst<T>(1.0f), Tbc,
                  r);
}

// S.W = L^-1 for L L^T = cov + 1e-8 I, the identity if not finite
__device__ void sqrt_info(Shared& S) {
    double Wd[81];
    const bool ok = imu::sqrt_info(S.pre + O_COV, Wd);
    for (int i = 0; i < 81; ++i) {
        S.W[i] = ok ? (float)Wd[i] : (i % 10 == 0 ? 1.0f : 0.0f);
    }
}

__global__ void __launch_bounds__(THREADS)
vi_pose_kernel(const float* __restrict__ pt_pos,
               const uint8_t* __restrict__ pt_valid, int n_pts,
               const float* __restrict__ uv, const float* __restrict__ depth,
               const uint8_t* __restrict__ fvalid,
               const int* __restrict__ slot_pt, int F,
               const float* __restrict__ T_j0, const float* __restrict__ v_j0,
               const float* __restrict__ T_i, const float* __restrict__ v_i,
               const float* __restrict__ pre, const float* __restrict__ T_bc,
               const float* __restrict__ cam, const float* __restrict__ bf_ptr,
               float wg, float wa, int iters, float* __restrict__ out,
               int* __restrict__ n_inl) {
    __shared__ Shared S;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int i = tid; i < P; i += THREADS) S.pre[i] = pre[i];
    if (tid < 7) {
        S.Ti[tid] = T_i[tid];
        S.Tbc[tid] = T_bc[tid];
        S.Tj[tid] = T_j0[tid];
    }
    if (tid < 3) {
        S.vi[tid] = v_i[tid];
        S.vj[tid] = v_j0[tid];
        S.bg[tid] = pre[O_BG + tid];
        S.ba[tid] = pre[O_BA + tid];
    }
    __syncthreads();
    if (tid == 0) sqrt_info(S);
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    const float bf = bf_ptr[0];
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        // ---- the preintegration rows, one forward-mode column a lane
        if (tid < 15) {
            Dual xi[6], Tj[7], E[7], vj[3], bgd[3], bad[3], r[9];
            for (int i = 0; i < 6; ++i) xi[i] = mkd(0.0f, i == tid ? 1.0f : 0.0f);
            for (int i = 0; i < 7; ++i) Tj[i] = mkd(S.Tj[i]);
            se3_exp(xi, E);
            Dual Tn[7];
            se3_mul(E, Tj, Tn);
            for (int i = 0; i < 3; ++i) {
                vj[i] = mkd(S.vj[i], tid == 6 + i ? 1.0f : 0.0f);
                bgd[i] = mkd(S.bg[i], tid == 9 + i ? 1.0f : 0.0f);
                bad[i] = mkd(S.ba[i], tid == 12 + i ? 1.0f : 0.0f);
            }
            imu_residual(S, Tn, vj, bgd, bad, r);
            for (int i = 0; i < 9; ++i) S.Jimu[i][tid] = r[i].d;
            if (tid == 0) {
                for (int i = 0; i < 9; ++i) S.rimu[i] = r[i].v;
            }
        }
        // ---- the reprojection rows
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
        const float q[4] = {S.Tj[0], S.Tj[1], S.Tj[2], S.Tj[3]};
        const float t0 = S.Tj[4], t1 = S.Tj[5], t2 = S.Tj[6];
        for (int m = tid; m < F; m += THREADS) {
            const int slot = slot_pt[m];
            const int pt = slot > 0 ? slot : 0;
            const bool obs_ok = slot >= 0 && pt < n_pts && pt_valid[pt] != 0 &&
                                fvalid[m] != 0;
            if (!obs_ok) continue;
            const float X[3] = {pt_pos[3 * pt], pt_pos[3 * pt + 1],
                                pt_pos[3 * pt + 2]};
            float p[3];
            quat_rot(q, X, p);
            p[0] += t0;
            p[1] += t1;
            p[2] += t2;
            const float z = p[2];
            const bool tiny = fabsf(z) < 1e-9f;
            const float iz = 1.0f / (tiny ? 1e-9f : z);
            const float u = fx * p[0] * iz + cx;
            const float v = fy * p[1] * iz + cy;
            const float du = u - uv[2 * m], dv = v - uv[2 * m + 1];
            const float chi2 = du * du + dv * dv;
            if (!(z > 0.05f && chi2 < CHI2 * 4.0f)) continue;
            const float w = fminf(1.0f, sqrtf(CHI2 / fmaxf(chi2, 1e-9f)));
            const float dm = depth[m];
            const bool has_d = dm > 0.0f;
            const float zc = fmaxf(z, 1e-6f);
            const float dinv = tiny ? 0.0f : iz * iz;
            const float res[3] = {
                du * w, dv * w,
                has_d ? ((u - bf / zc) - (uv[2 * m] - bf / dm)) * w : 0.0f};
            const float ws = has_d ? w : 0.0f;
            const float dz_ur = z > 1e-6f ? bf / (zc * zc) : 0.0f;
            const float rows[3][3] = {
                {fx * iz * w, 0.0f, -fx * p[0] * dinv * w},
                {0.0f, fy * iz * w, -fy * p[1] * dinv * w},
                {fx * iz * ws, 0.0f, (-fx * p[0] * dinv + dz_ur) * ws}};
            for (int rr = 0; rr < 3; ++rr) {
                const float a0 = rows[rr][0], a1 = rows[rr][1],
                            a2 = rows[rr][2];
                const float J[6] = {a0, a1, a2, -a1 * p[2] + a2 * p[1],
                                    a0 * p[2] - a2 * p[0],
                                    -a0 * p[1] + a1 * p[0]};
                int k = 0;
#pragma unroll
                for (int i = 0; i < 6; ++i) {
#pragma unroll
                    for (int j = i; j < 6; ++j) acc[k++] += J[i] * J[j];
                }
#pragma unroll
                for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * res[rr];
            }
        }
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
            const float s = vsg_warp_sum(acc[k]);
            if (lane == 0) S.red[warp][k] = s;
        }
        __syncthreads();
        if (tid < NACC) {
            float s = 0.0f;
            for (int wi = 0; wi < NWARP; ++wi) s += S.red[wi][tid];
            S.tot[tid] = s;
        }
        __syncthreads();
        if (tid == 0) {
            // ---- assemble JᵀJ + 1e-6 I, Jᵀr in float64 and solve
            int k = 0;
            for (int i = 0; i < 15; ++i) {
                for (int j = 0; j < 15; ++j) {
                    double s = 0.0;
                    for (int r = 0; r < 9; ++r) {
                        s += (double)S.Jimu[r][i] * (double)S.Jimu[r][j];
                    }
                    S.H[i][j] = s;
                }
                double s = 0.0;
                for (int r = 0; r < 9; ++r) {
                    s += (double)S.Jimu[r][i] * (double)S.rimu[r];
                }
                S.g[i] = s;
            }
            for (int i = 0; i < 6; ++i) {
                for (int j = i; j < 6; ++j) {
                    S.H[i][j] += (double)S.tot[k];
                    if (j != i) S.H[j][i] += (double)S.tot[k];
                    ++k;
                }
                S.g[i] += (double)S.tot[21 + i];
            }
            for (int i = 0; i < 3; ++i) {
                const float rbg = (S.bg[i] - S.pre[O_BG + i]) * wg;
                const float rba = (S.ba[i] - S.pre[O_BA + i]) * wa;
                S.H[9 + i][9 + i] += (double)wg * (double)wg;
                S.H[12 + i][12 + i] += (double)wa * (double)wa;
                S.g[9 + i] += (double)wg * (double)rbg;
                S.g[12 + i] += (double)wa * (double)rba;
            }
            for (int i = 0; i < 15; ++i) {
                S.H[i][i] += 1e-6;
                S.g[i] = -S.g[i];
            }
            solve_dense<15>(S.H, S.g, S.dx);
            float dx[15];
            for (int i = 0; i < 15; ++i) {
                const float d = (float)S.dx[i];
                dx[i] = isfinite(d) ? d : 0.0f;
            }
            float E[7], Tn[7];
            se3_exp(dx, E);
            se3_mul(E, S.Tj, Tn);
            quat_normalize(Tn);
            for (int i = 0; i < 7; ++i) S.Tj[i] = Tn[i];
            for (int i = 0; i < 3; ++i) {
                S.vj[i] += dx[6 + i];
                S.bg[i] += dx[9 + i];
                S.ba[i] += dx[12 + i];
            }
        }
        __syncthreads();
    }

    // ---- inliers at the solution
    const float q[4] = {S.Tj[0], S.Tj[1], S.Tj[2], S.Tj[3]};
    int cnt = 0;
    for (int m = tid; m < F; m += THREADS) {
        const int slot = slot_pt[m];
        const int pt = slot > 0 ? slot : 0;
        if (!(slot >= 0 && pt < n_pts && pt_valid[pt] != 0 && fvalid[m] != 0)) {
            continue;
        }
        const float X[3] = {pt_pos[3 * pt], pt_pos[3 * pt + 1],
                            pt_pos[3 * pt + 2]};
        float p[3];
        quat_rot(q, X, p);
        for (int i = 0; i < 3; ++i) p[i] += S.Tj[4 + i];
        const float iz = 1.0f / (fabsf(p[2]) < 1e-9f ? 1e-9f : p[2]);
        const float du = fx * p[0] * iz + cx - uv[2 * m];
        const float dv = fy * p[1] * iz + cy - uv[2 * m + 1];
        cnt += (du * du + dv * dv < CHI2) ? 1 : 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) S.cnt[warp] = cnt;
    __syncthreads();
    if (tid == 0) {
        int total = 0;
        for (int wi = 0; wi < NWARP; ++wi) total += S.cnt[wi];
        *n_inl = total;
        for (int i = 0; i < 7; ++i) out[i] = S.Tj[i];
        for (int i = 0; i < 3; ++i) {
            out[7 + i] = S.vj[i];
            out[10 + i] = S.bg[i];
            out[13 + i] = S.ba[i];
        }
    }
}

}  // namespace

// pt_pos: (n_pts, 3) f32; pt_valid: (n_pts,) u8; uv: (F, 2); depth: (F,);
// fvalid: (F,) u8; slot_pt: (F,) i32 map point per keypoint or -1;
// T_j0 / T_i: (7,) initial and last-frame poses; v_j0 / v_i: (3,); pre:
// (143,) packed frame preintegration (its biases start the solve); T_bc:
// (7,); cam: (4,) [fx, fy, cx, cy]; bf_ptr: () f32; wg / wa: bias-walk
// weights.  Writes out (16,) [T_j (7), v_j, bg, ba] and n_inl () i32.
VSG_API int vsg_vi_pose(const float* pt_pos, const uint8_t* pt_valid,
                        int n_pts, const float* uv, const float* depth,
                        const uint8_t* fvalid, const int* slot_pt, int F,
                        const float* T_j0, const float* v_j0,
                        const float* T_i, const float* v_i, const float* pre,
                        const float* T_bc, const float* cam,
                        const float* bf_ptr, float wg, float wa, int iters,
                        float* out, int* n_inl, cudaStream_t stream) {
    vi_pose_kernel<<<1, THREADS, 0, stream>>>(
        pt_pos, pt_valid, n_pts, uv, depth, fvalid, slot_pt, F, T_j0, v_j0,
        T_i, v_i, pre, T_bc, cam, bf_ptr, wg, wa, iters, out, n_inl);
    return (int)cudaGetLastError();
}
