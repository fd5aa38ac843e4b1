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
// ops it is hundreds of launches.  Its first design (one block, the
// float64 assembly and elimination on one thread over shared memory) spent
// 90 % of each iteration there: 46k and 92k of 154k SM cycles, and 41k
// cycles once a solve in the sqrt information (clock64, PERF.md).
//
// Design: one block of 256 threads keeps the state (T_j, v_j, bg, ba) in
// shared memory and loops over the iterations inside the kernel, two block
// barriers an iteration:
// - warp 0, lanes 0-14, evaluates the preintegration residual
//   (imu.cuh, shared with K22b) in forward mode, one dual-number
//   direction a lane (lie.cuh's templates transcribe core/lie.py branch
//   for branch, so each lane computes the column jax.jacfwd computes),
//   into a 9x15 Jacobian in shared memory, while warps 1-7 walk the
//   features: IRLS weight (Huber, 4 χ² gate) from the current
//   reprojection, the weighted rows and their analytic Jacobian in the
//   left pose perturbation, J = Jp [I | -[p]x] (only the 6 pose columns
//   are non-zero), accumulated as 21 + 6 normal-equation sums in float32
//   and reduced by warp shuffles into shared memory;
// - barrier; warp 0 alone then assembles JᵀJ + 1e-6 I and Jᵀr in float64
//   with one row a lane held in registers (15 nine-term dots, the pose
//   block's warp sums, the bias walks), eliminates it with partial
//   pivoting, the pivot chosen by a shuffle arg-max over the rows' lanes
//   and the row exchanges kept as a permutation of the lanes, substitutes
//   back (each entry the same float64 operations in the same order as
//   lie.cuh::solve_dense, the twin's algorithm), zeroes non-finite steps
//   and applies exp(dx) T_j (renormalised), v + dx, bg + dx, ba + dx;
// - barrier.
// The preintegration's sqrt information (the inverse of the Cholesky
// factor of cov + 1e-8 I, the identity if that is not finite) is computed
// once a solve in float64 by warp 0, one row (Cholesky) or one column (the
// triangular inverse) a lane.  After the last iteration the block counts
// the inliers (2-dof χ² < 7.815).  The solve runs in float64 where the
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
constexpr int NX = 15;
constexpr float CHI2 = 7.815f;

struct Shared {
    float pre[P];
    float W[81];  // sqrt information, row-major
    float Ti[7], vi[3], Tbc[7];
    float Ri[9], pi[3];  // frame i's body state, fixed over the solve
    float Tj[7], vj[3], bg[3], ba[3];
    __align__(16) float Jimu[9][16];
    float rimu[9];
    float red[NWARP][NACC];
    int cnt[NWARP];
};

// inertial/factors.py::_imu_residual with T_i, v_i fixed, scale 1 and
// g = (0, 0, -9.81), whitened: W [r_R, r_V, r_P] (imu.cuh); frame i's
// body state is S.Ri / S.pi (imu::body_state once a solve: the same
// values its constant dual numbers would carry)
template <typename T>
__device__ void imu_residual(const Shared& S, const T* Tj, const T* vj,
                             const T* bg, const T* ba, T* r) {
    T Tbc[7], Ri[9], pi[3], Rj[9], pj[3], vi[3], g[3];
    for (int i = 0; i < 7; ++i) Tbc[i] = cst<T>(S.Tbc[i]);
    for (int i = 0; i < 9; ++i) Ri[i] = cst<T>(S.Ri[i]);
    for (int i = 0; i < 3; ++i) {
        pi[i] = cst<T>(S.pi[i]);
        vi[i] = cst<T>(S.vi[i]);
        g[i] = cst<T>(i == 2 ? -GRAVITY : 0.0f);
    }
    imu::body_state(Tj, Tbc, Rj, pj);
    imu::residual_body(S.pre, S.W, Ri, pi, Rj, pj, vi, vj, bg, ba, g,
                       cst<T>(1.0f), r);
}

// S.W = L^-1 for L L^T = cov + 1e-8 I, the identity if not finite, on
// warp 0 (imu.cuh::sqrt_info_warp: a row of L, then a column of W, a lane)
__device__ void sqrt_info_warp(Shared& S, int lane) {
    double Wc[9];
    const bool ok = imu::sqrt_info_warp(S.pre + O_COV, lane, Wc);
    if (lane < 9) {
#pragma unroll
        for (int r = 0; r < 9; ++r) {
            S.W[9 * r + lane] = ok ? (float)Wc[r] : (r == lane ? 1.0f : 0.0f);
        }
    }
}

// index of pose-block entry (i, j), i <= j < 6, in the 21 packed sums
__device__ __forceinline__ int tri(int i, int j) {
    return i * 6 - i * (i - 1) / 2 + (j - i);
}

// warp 0, lane r < 15: row r of the damped normal equations JᵀJ + 1e-6 I
// and of -Jᵀr, in float64
__device__ __forceinline__ void assemble_row(const Shared& S, int lane,
                                             float wg, float wa,
                                             double (&a)[NX], double& b) {
    const int r = lane < NX ? lane : NX - 1;
    {
        double Jr[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) Jr[k] = (double)S.Jimu[k][r];
#pragma unroll
        for (int j = 0; j < NX; ++j) a[j] = 0.0;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            // row k of the Jacobian, four columns a load
            const float4* row = reinterpret_cast<const float4*>(S.Jimu[k]);
#pragma unroll
            for (int j4 = 0; j4 < 4; ++j4) {
                const float4 c = row[j4];
                const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    if (4 * j4 + jj < NX) {
                        a[4 * j4 + jj] += Jr[k] * (double)cs[jj];
                    }
                }
            }
        }
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 9; ++k) s += Jr[k] * (double)S.rimu[k];
        b = s;
    }
    if (r < 6) {
        // the pose block: the walking warps' sums in warp order
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            const int k = r <= j ? tri(r, j) : tri(j, r);
            float t = 0.0f;
            for (int w = 1; w < NWARP; ++w) t += S.red[w][k];
            a[j] += (double)t;
        }
        float t = 0.0f;
        for (int w = 1; w < NWARP; ++w) t += S.red[w][21 + r];
        b += (double)t;
    } else if (r >= 9) {
        const int i = r < 12 ? r - 9 : r - 12;
        const float wb = r < 12 ? wg : wa;
        const float rb = r < 12 ? (S.bg[i] - S.pre[O_BG + i]) * wg
                                : (S.ba[i] - S.pre[O_BA + i]) * wa;
#pragma unroll
        for (int j = 9; j < NX; ++j) {
            if (j == r) a[j] += (double)wb * (double)wb;
        }
        b += (double)wb * (double)rb;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
        if (j == r) a[j] += 1e-6;
    }
    b = -b;
}

// warp 0: x = A^-1 b by solve_dense's elimination with partial pivoting
// and back substitution, lane r holding row r of (A, b) in registers; the
// rows' exchanges are a permutation of the lanes (pos, a row's current
// position).  Every lane returns the step, non-finite entries zeroed.
__device__ __forceinline__ void eliminate(double (&a)[NX], double b,
                                          int lane, float (&dx)[NX]) {
    const bool live = lane < NX;
    int pos = live ? lane : NX + lane;
    int piv[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
        // the first largest |A[., c]| at positions >= c (a NaN on the
        // diagonal keeps its row, one below it is never taken): the
        // magnitudes' bits order as unsigned integers, so three warp
        // reductions find the largest and then its lowest position
        const bool cand = live && pos >= c;
        double v = fabs(a[c]);
        if (isnan(v)) v = pos == c ? INFINITY : 0.0;
        const unsigned long long key =
            cand ? (unsigned long long)__double_as_longlong(v) : 0ull;
        const unsigned hi = __reduce_max_sync(0xffffffffu,
                                              (unsigned)(key >> 32));
        const unsigned lo = __reduce_max_sync(
            0xffffffffu, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
        const bool top = cand && (unsigned)(key >> 32) == hi &&
                         (unsigned)key == lo;
        const int p = (int)__reduce_min_sync(0xffffffffu,
                                             top ? (unsigned)pos : ~0u);
        // exchange positions c and p
        if (pos == p) {
            pos = c;
        } else if (pos == c) {
            pos = p;
        }
        const int src = __ffs(__ballot_sync(0xffffffffu, pos == c)) - 1;
        piv[c] = src;
        const double pc = __shfl_sync(0xffffffffu, a[c], src);
        const double f = a[c] / pc;
#pragma unroll
        for (int k = c; k < NX; ++k) {
            const double pk = __shfl_sync(0xffffffffu, a[k], src);
            if (pos > c) a[k] = fma(-f, pk, a[k]);
        }
        const double pb = __shfl_sync(0xffffffffu, b, src);
        if (pos > c) b = fma(-f, pb, b);
    }
    // ---- back substitution
    double x[NX];
#pragma unroll
    for (int c = NX - 1; c >= 0; --c) {
        double s = b;
#pragma unroll
        for (int k = c + 1; k < NX; ++k) s = fma(-a[k], x[k], s);
        x[c] = __shfl_sync(0xffffffffu, s / a[c], piv[c]);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
        const float d = (float)x[i];
        dx[i] = isfinite(d) ? d : 0.0f;
    }
}

// warp 0: exp(dx) T_j (renormalised) on lane 0, v, bg, ba + dx a component
// a lane
__device__ __forceinline__ void retract(Shared& S, int lane,
                                        const float (&dx)[NX]) {
    __syncwarp();
    if (lane == 0) {
        float E[7], Tn[7];
        se3_exp(dx, E);
        se3_mul(E, S.Tj, Tn);
        quat_normalize(Tn);
        for (int i = 0; i < 7; ++i) S.Tj[i] = Tn[i];
    } else if (lane >= 6 && lane < NX) {
        float d = 0.0f;
#pragma unroll
        for (int i = 6; i < NX; ++i) {
            if (i == lane) d = dx[i];
        }
        float* st = lane < 9 ? S.vj : lane < 12 ? S.bg : S.ba;
        st[(lane - 6) % 3] += d;
    }
}

// kProf: thread 0 stamps its clock (clock64) into prof at the section
// boundaries; only the instrumented entry (vsg_vi_pose_sections) sets it
template <bool kProf>
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
               int* __restrict__ n_inl, long long* __restrict__ prof) {
    __shared__ Shared S;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    int n_stamp = 0;
    auto stamp = [&]() {
        if constexpr (kProf) {
            if (threadIdx.x == 0) prof[n_stamp++] = clock64();
        }
    };
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
    stamp();
    if (tid == 32) imu::body_state(S.Ti, S.Tbc, S.Ri, S.pi);
    if (warp == 0) sqrt_info_warp(S, lane);
    stamp();
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    const float bf = bf_ptr[0];
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        stamp();
        if (warp == 0) {
            // ---- the preintegration rows, one forward-mode column a lane
            if (lane < NX) {
                Dual xi[6], Tj[7], E[7], vj[3], bgd[3], bad[3], r[9];
                for (int i = 0; i < 6; ++i) {
                    xi[i] = mkd(0.0f, i == lane ? 1.0f : 0.0f);
                }
                for (int i = 0; i < 7; ++i) Tj[i] = mkd(S.Tj[i]);
                se3_exp(xi, E);
                Dual Tn[7];
                se3_mul(E, Tj, Tn);
                for (int i = 0; i < 3; ++i) {
                    vj[i] = mkd(S.vj[i], lane == 6 + i ? 1.0f : 0.0f);
                    bgd[i] = mkd(S.bg[i], lane == 9 + i ? 1.0f : 0.0f);
                    bad[i] = mkd(S.ba[i], lane == 12 + i ? 1.0f : 0.0f);
                }
                imu_residual(S, Tn, vj, bgd, bad, r);
                for (int i = 0; i < 9; ++i) S.Jimu[i][lane] = r[i].d;
                if (lane == 0) {
                    for (int i = 0; i < 9; ++i) S.rimu[i] = r[i].v;
                }
            }
            stamp();
        } else {
            // ---- the reprojection rows on warps 1-7
            float acc[NACC];
#pragma unroll
            for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
            const float q[4] = {S.Tj[0], S.Tj[1], S.Tj[2], S.Tj[3]};
            const float t0 = S.Tj[4], t1 = S.Tj[5], t2 = S.Tj[6];
            for (int m = tid - 32; m < F; m += THREADS - 32) {
                const int slot = slot_pt[m];
                const int pt = slot > 0 ? slot : 0;
                const bool obs_ok = slot >= 0 && pt < n_pts &&
                                    pt_valid[pt] != 0 && fvalid[m] != 0;
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
                    has_d ? ((u - bf / zc) - (uv[2 * m] - bf / dm)) * w
                          : 0.0f};
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
        }
        __syncthreads();
        stamp();
        if (warp == 0) {
            double a[NX], b;
            assemble_row(S, lane, wg, wa, a, b);
            stamp();
            float dx[NX];
            eliminate(a, b, lane, dx);
            stamp();
            retract(S, lane, dx);
        }
        __syncthreads();
    }
    stamp();

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
    stamp();
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
    vi_pose_kernel<false><<<1, THREADS, 0, stream>>>(
        pt_pos, pt_valid, n_pts, uv, depth, fvalid, slot_pt, F, T_j0, v_j0,
        T_i, v_i, pre, T_bc, cam, bf_ptr, wg, wa, iters, out, n_inl, nullptr);
    return (int)cudaGetLastError();
}

// vsg_vi_pose, instrumented: also writes prof (n_prof,) int64, thread 0's
// clock64 at the section boundaries (4 + 5 iters of them).
VSG_API int vsg_vi_pose_sections(
    const float* pt_pos, const uint8_t* pt_valid, int n_pts, const float* uv,
    const float* depth, const uint8_t* fvalid, const int* slot_pt, int F,
    const float* T_j0, const float* v_j0, const float* T_i, const float* v_i,
    const float* pre, const float* T_bc, const float* cam,
    const float* bf_ptr, float wg, float wa, int iters, float* out,
    int* n_inl, long long* prof, int n_prof, cudaStream_t stream) {
    if (prof == nullptr || iters < 0 || n_prof < 4 + 5 * iters) {
        return (int)cudaErrorInvalidValue;
    }
    vi_pose_kernel<true><<<1, THREADS, 0, stream>>>(
        pt_pos, pt_valid, n_pts, uv, depth, fvalid, slot_pt, F, T_j0, v_j0,
        T_i, v_i, pre, T_bc, cam, bf_ptr, wg, wa, iters, out, n_inl, prof);
    return (int)cudaGetLastError();
}
