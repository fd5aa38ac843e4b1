// K6: motion-only Gauss-Newton pose solve (IRLS Huber + chi2 gate
// schedule, RGB-D stereo row, optional pose prior), the whole iteration
// schedule in one launch.
//
// Replaces visual_sgraphs_tpu/slam/tracking.py::pose_only_gn and its prior
// branch (tracking.py:183-187).  The JAX version is a lax.scan of 12 steps,
// each building (M, 3, 6) Jacobians, a (6, 3M) x (3M, 6) matmul and a 6x6
// solve as separate XLA ops.
//
// What bounds it here: latency, not flops or bytes — M <= 4096 matches is
// ~100 KB of input and ~1 MFLOP an iteration, and every iteration ends in
// a 6x6 solve that the next one waits for.
//
// Design: a cluster of C CTAs of 256 threads (C from M,
// tracking.py::pose_gn_plan: one CTA up to 512 matches, 8 at 4096).  CTA
// c copies its 1/C share of the matches into shared memory once
// (cp.async), with the stereo row's per-match constants (the observed
// right coordinate, its weight) computed there, and keeps it for every
// iteration.  An iteration: each thread takes its matches two at a time
// (both matches' rows computed before either is added) and accumulates
// the 21 upper-triangular J^T W J and 6 J^T W r entries in registers,
// skipping each row's Jacobian entry that is zero by construction (wide
// gate for the first max(iters/4, 1) iterations when gate0 > final_gate);
// a transposed warp reduction (31 shuffles) leaves lane k with the warp's
// sum k; warp 0 sums the warps in order and writes the CTA's partial into
// row c of every CTA's inbox through distributed shared memory; one
// cluster barrier, and warp 0 of every CTA sums its inbox's rows in rank
// order — no float atomics, so every CTA holds bitwise the same 27 sums,
// run after run.  Warp 0 then solves: with a pose prior (the inertial
// path's dead-reckoned prediction) it adds w I to H and w log(T T_prior^-1)
// to g first (the reference's J = I approximation; T_prior^-1 is taken
// once, the log between the barrier's arrive and wait), the damped 6x6
// Cholesky in registers, non-finite steps zeroed, and exp(dx) * T with
// renormalisation; a block barrier hands the pose to the other warps, so
// every CTA holds the same pose with no second cluster barrier.  The
// inboxes are double-buffered by iteration parity, so one cluster barrier
// an iteration suffices.  The final 2-dof inlier test runs at the
// solution, each CTA on its own matches.  Sums are taken in another order
// than the plain PyTorch version, so poses agree to a tolerance, not
// bitwise.
#include <cooperative_groups.h>

#include "lie.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr unsigned FULL = 0xffffffffu;

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
// (lie.se3_normalize(lie.se3_boxplus(T, dx))).  dx is the same on every
// lane, so only the branch its angle needs is evaluated.
__device__ __forceinline__ void boxplus_normalize(Pose& T,
                                                  const float dx[6]) {
    const float* rho = dx;
    const float* om = dx + 3;
    const float th2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
    float k, qw, a, b;
    if (th2 < 1e-8f) {
        k = 0.5f - th2 / 48.0f;
        qw = 1.0f - th2 / 8.0f;
        a = 0.5f - th2 / 24.0f;
        b = 1.0f / 6.0f - th2 / 120.0f;
    } else {
        const float th = sqrtf(th2);
        float sh, ch, st, ct;
        sincosf(0.5f * th, &sh, &ch);
        sincosf(th, &st, &ct);
        k = sh / th;
        qw = ch;
        a = (1.0f - ct) / th2;
        b = (th - st) / (th2 * th);
    }
    float qe[4] = {qw, k * om[0], k * om[1], k * om[2]};
    const float n2 = qe[0] * qe[0] + qe[1] * qe[1] + qe[2] * qe[2] +
                     qe[3] * qe[3];
    const float inv_n = sqrtf(1.0f / fmaxf(n2, 1.17549435e-38f));
    for (int i = 0; i < 4; ++i) qe[i] *= inv_n;
    // V = I + a W + b W^2
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

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// One halving exchange of transpose_sum: lanes with bit H set keep the
// upper H of their first 2H values and receive the partner's upper H,
// the others the lower H.
template <int H>
__device__ __forceinline__ void halve(float* v, bool up) {
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float lo = v[i], hi = v[i + H];
        v[i] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, H);
    }
}

// Lane k returns the warp's sum of v[k]: five halving exchanges (31
// shuffles), each lane keeping the half its lane bit selects.
__device__ __forceinline__ float transpose_sum(float* v, int lane) {
    halve<16>(v, lane & 16);
    halve<8>(v, lane & 8);
    halve<4>(v, lane & 4);
    halve<2>(v, lane & 2);
    halve<1>(v, lane & 1);
    return v[0];
}

// Solve (H + 1e-3 I) dx = -g, lane k of the warp holding sum k (H's 21
// upper entries row by row, then g): the sums broadcast to every lane,
// then the Cholesky (rsqrt pivots), forward and back substitutions in
// registers; non-finite steps are zeroed.
__device__ __forceinline__ void solve6(float tot, float dx[6]) {
    float A[6][6], g[6];
    int n = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
            A[i][j] = A[j][i] = __shfl_sync(FULL, tot, n++);
        }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        g[i] = __shfl_sync(FULL, tot, 21 + i);
        A[i][i] += 1e-3f;
    }
    float L[6][6], dinv[6], y[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        float d = A[j][j];
#pragma unroll
        for (int p = 0; p < j; ++p) d -= L[j][p] * L[j][p];
        dinv[j] = rsqrtf(d);
        L[j][j] = d * dinv[j];
#pragma unroll
        for (int i = j + 1; i < 6; ++i) {
            float t = A[i][j];
#pragma unroll
            for (int p = 0; p < j; ++p) t -= L[i][p] * L[j][p];
            L[i][j] = t * dinv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float t = -g[i];
#pragma unroll
        for (int p = 0; p < i; ++p) t -= L[i][p] * y[p];
        y[i] = t * dinv[i];
    }
#pragma unroll
    for (int r = 5; r >= 0; --r) {
        float t = y[r];
#pragma unroll
        for (int p = r + 1; p < 6; ++p) t -= L[p][r] * dx[p];
        dx[r] = t * dinv[r];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) dx[r] = isfinite(dx[r]) ? dx[r] : 0.0f;
}

// One match's rows at the current pose: the robust weight, the three rows
// of d(residual)/d(p) and the residuals; ok is false for a match that
// does not count (invalid, behind the camera or past the gate).
struct Terms {
    float px, py, pz, w;
    float rows[3][3];
    float res[3];
    bool ok;
};

__device__ __forceinline__ Terms match_terms(
    int m, const float* sx, const float* su, const float* sur,
    const float* ss3, const uint8_t* sv, const float R[9], float t0,
    float t1, float t2, float fx, float fy, float cx, float cy, float bf,
    bool stereo, float gate, float huber) {
    Terms T;
    const float X = sx[3 * m], Y = sx[3 * m + 1], Z = sx[3 * m + 2];
    T.px = R[0] * X + R[1] * Y + R[2] * Z + t0;
    T.py = R[3] * X + R[4] * Y + R[5] * Z + t1;
    T.pz = R[6] * X + R[7] * Y + R[8] * Z + t2;
    const float z = fmaxf(T.pz, 1e-6f);
    const float iz = 1.0f / z;
    const float u_hat = fx * T.px * iz + cx;
    const float v_hat = fy * T.py * iz + cy;
    const uint8_t flags = sv[m];
    T.res[0] = u_hat - su[2 * m];
    T.res[1] = v_hat - su[2 * m + 1];
    float s3 = 0.0f;  // has_d * w_ur
    T.res[2] = 0.0f;
    if (stereo && (flags & 2)) {
        s3 = ss3[m];
        T.res[2] = ((u_hat - bf * iz) - sur[m]) * s3;
    }
    const float chi2 =
        T.res[0] * T.res[0] + T.res[1] * T.res[1] + T.res[2] * T.res[2];
    T.ok = (flags & 1) && T.pz > 0.05f && chi2 <= gate;
    const float s = sqrtf(fmaxf(chi2, 1e-12f));
    T.w = fminf(1.0f, huber / s);
    const float iz2 = iz * iz;
    T.rows[0][0] = fx * iz;
    T.rows[0][1] = 0.0f;
    T.rows[0][2] = -fx * T.px * iz2;
    T.rows[1][0] = 0.0f;
    T.rows[1][1] = fy * iz;
    T.rows[1][2] = -fy * T.py * iz2;
    T.rows[2][0] = fx * iz * s3;
    T.rows[2][1] = 0.0f;
    T.rows[2][2] = (-fx * T.px + bf) * iz2 * s3;
    return T;
}

// acc += w J^T J (21 upper entries) and w J^T r for one row J whose
// entry Z is zero by construction: the terms with Z are skipped (they
// add an exact zero).
template <int Z>
__device__ __forceinline__ void add_row(float* acc, float w, const float* J,
                                        float r) {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const float wj = w * J[i];
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) {
            if (i != Z && j != Z) acc[k] += wj * J[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        if (i != Z) acc[21 + i] += w * J[i] * r;
    }
}

// The rows of J = [d(residual)/d(p)] [I | -hat(p)]: rows 0 and 2 have no
// y term (entry 1 is zero), row 1 no x term (entry 0).
__device__ __forceinline__ void accumulate(float* acc, const Terms& T,
                                           bool stereo) {
    const float px = T.px, py = T.py, pz = T.pz;
    {
        const float a0 = T.rows[0][0], a2 = T.rows[0][2];
        const float J[6] = {a0, 0.0f, a2, a2 * py, a0 * pz - a2 * px,
                            -a0 * py};
        add_row<1>(acc, T.w, J, T.res[0]);
    }
    {
        const float a1 = T.rows[1][1], a2 = T.rows[1][2];
        const float J[6] = {0.0f, a1, a2, -a1 * pz + a2 * py, -a2 * px,
                            a1 * px};
        add_row<0>(acc, T.w, J, T.res[1]);
    }
    if (stereo) {
        const float a0 = T.rows[2][0], a2 = T.rows[2][2];
        const float J[6] = {a0, 0.0f, a2, a2 * py, a0 * pz - a2 * px,
                            -a0 * py};
        add_row<1>(acc, T.w, J, T.res[2]);
    }
}

__global__ void __launch_bounds__(THREADS)
pose_gn_kernel(const float* __restrict__ T_init, const float* __restrict__ xw,
               const float* __restrict__ uv,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ cam, const float* __restrict__ depth,
               const float* __restrict__ bf_ptr, int n, int chunk, int iters,
               int n_wide, float gate0, float final_gate, float huber,
               float chi2_gate, const float* __restrict__ T_prior,
               float prior_weight, float* __restrict__ T_out,
               uint8_t* __restrict__ inliers) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float red[NWARP][32];
    // the CTAs' partials, row k from CTA k, by iteration parity
    __shared__ float inbox[2][MAX_CLUSTER][32];
    __shared__ Pose sT;  // warp 0's new pose, for the other warps
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks();
    const int c = (int)cl.block_rank();
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int m0 = min(n, c * chunk);
    const int cnt = min(n, m0 + chunk) - m0;
    const bool stereo = depth != nullptr;
    const bool prior = T_prior != nullptr;
    const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
    const float bf = stereo ? bf_ptr[0] : 0.0f;

    // this CTA's matches, once: xw (3 chunk), uv (2 chunk), the stereo
    // row's observed right coordinate and weight (chunk each), flags
    // (chunk bytes: valid, has depth)
    float* sx = smem;
    float* su = sx + 3 * chunk;
    float* sur = su + 2 * chunk;
    float* ss3 = sur + chunk;
    uint8_t* sv = reinterpret_cast<uint8_t*>(ss3 + chunk);
    for (int k = tid; k < 3 * cnt; k += THREADS) {
        cp_async4(sx + k, xw + 3 * (size_t)m0 + k);
    }
    for (int k = tid; k < 2 * cnt; k += THREADS) {
        cp_async4(su + k, uv + 2 * (size_t)m0 + k);
    }
    for (int k = tid; k < cnt; k += THREADS) {
        const bool vm = valid[m0 + k] != 0;
        bool has_d = false;
        if (stereo) {
            const float dm = depth[m0 + k];
            has_d = vm && dm > 0.0f;
            const float q = 2.5f / fmaxf(dm, 0.1f);
            sur[k] = uv[2 * (size_t)(m0 + k)] - bf / dm;
            ss3[k] = fminf(1.0f, q * q);
        }
        sv[k] = (vm ? 1 : 0) | (has_d ? 2 : 0);
    }
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
                 "memory");

    Pose T;
    for (int k = 0; k < 4; ++k) T.q[k] = T_init[k];
    for (int k = 0; k < 3; ++k) T.t[k] = T_init[4 + k];
    float Pinv[7];
    if (prior) {
        float Tp[7];
        for (int k = 0; k < 7; ++k) Tp[k] = T_prior[k];
        se3_inv(Tp, Pinv);
    }
    __syncthreads();
    // every CTA of the cluster has started before the first push (the
    // matching wait is in the first iteration)
    cluster_arrive();

    for (int it = 0; it < iters; ++it) {
        const float gate = it < n_wide ? gate0 : final_gate;
        float R[9];
        quat_to_rot(T.q, R);
        float acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
        // two matches a step, their terms computed before either is added
        for (int m = tid; m < cnt; m += 2 * THREADS) {
            const int m2 = min(m + THREADS, cnt - 1);
            const Terms A = match_terms(m, sx, su, sur, ss3, sv, R, T.t[0],
                                        T.t[1], T.t[2], fx, fy, cx, cy, bf,
                                        stereo, gate, huber);
            const Terms B = match_terms(m2, sx, su, sur, ss3, sv, R, T.t[0],
                                        T.t[1], T.t[2], fx, fy, cx, cy, bf,
                                        stereo, gate, huber);
            if (A.ok) accumulate(acc, A, stereo);
            if (B.ok && m + THREADS < cnt) accumulate(acc, B, stereo);
        }
        red[warp][lane] = transpose_sum(acc, lane);
        if (it == 0) cluster_wait();
        __syncthreads();
        float (*box)[32] = inbox[it & 1];
        if (warp == 0) {
            // this CTA's partial, pushed into row c of every CTA's inbox
            float p = 0.0f;
            for (int w = 0; w < NWARP; ++w) p += red[w][lane];
            for (int k = 0; k < C; ++k) cl.map_shared_rank(&box[c][0], k)[lane] = p;
        }
        cluster_arrive();
        float rp[6];
        if (prior && warp == 0) {
            // r_p = log(T T_prior^-1)
            const float Tc[7] = {T.q[0], T.q[1], T.q[2], T.q[3],
                                 T.t[0], T.t[1], T.t[2]};
            float D[7];
            se3_mul(Tc, Pinv, D);
            se3_log(D, rp);
        }
        cluster_wait();
        if (warp == 0) {
            float tot = box[0][lane];
            for (int k = 1; k < C; ++k) tot += box[k][lane];
            if (prior) {
                // H += w I (upper entries 0, 6, 11, 15, 18, 20), g += w r_p
                if (lane == 0 || lane == 6 || lane == 11 || lane == 15 ||
                    lane == 18 || lane == 20) {
                    tot += prior_weight;
                }
#pragma unroll
                for (int k = 0; k < 6; ++k) {
                    if (lane == 21 + k) tot += prior_weight * rp[k];
                }
            }
            float dx[6];
            solve6(tot, dx);
            boxplus_normalize(T, dx);
            if (lane == 0) sT = T;
        }
        __syncthreads();
        T = sT;
    }
    if (iters == 0) cluster_wait();

    for (int m = tid; m < cnt; m += THREADS) {
        float p[3];
        quat_rotate(T.q, sx + 3 * m, p);
        p[0] += T.t[0];
        p[1] += T.t[1];
        p[2] += T.t[2];
        const float zz = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
        const float iz = 1.0f / zz;
        const float du = fx * p[0] * iz + cx - su[2 * m];
        const float dv = fy * p[1] * iz + cy - su[2 * m + 1];
        const float chi2 = du * du + dv * dv;
        inliers[m0 + m] =
            ((sv[m] & 1) && p[2] > 0.05f && chi2 <= chi2_gate) ? 1 : 0;
    }
    if (c == 0 && tid == 0) {
        for (int k = 0; k < 4; ++k) T_out[k] = T.q[k];
        for (int k = 0; k < 3; ++k) T_out[4 + k] = T.t[k];
    }
}

}  // namespace

// T_init: (7,) f32; xw: (n, 3); uv: (n, 2); valid: (n,) u8; cam: (4,)
// [fx, fy, cx, cy]; depth: (n,) f32 or NULL (no stereo row); bf_ptr: ()
// f32 (read only with depth); T_prior: (7,) f32 or NULL (no prior),
// weighted by prior_weight.  The plan (tracking.py::pose_gn_plan): a
// cluster of C CTAs, chunk matches a CTA (C x chunk >= n), smem bytes of
// dynamic shared memory a CTA.  Writes T_out (7,) and inliers (n,) u8.
VSG_API int vsg_pose_gn(const float* T_init, const float* xw, const float* uv,
                        const uint8_t* valid, const float* cam,
                        const float* depth, const float* bf_ptr, int n,
                        int C, int chunk, int smem, int iters, int n_wide,
                        float gate0, float final_gate, float huber,
                        float chi2_gate, const float* T_prior,
                        float prior_weight, float* T_out, uint8_t* inliers,
                        cudaStream_t stream) {
    if (C < 1 || C > MAX_CLUSTER || (long long)C * chunk < n) {
        return (int)cudaErrorInvalidValue;
    }
    static int smem_set = 0;
    cudaError_t err;
    if (smem > smem_set) {
        err = cudaFuncSetAttribute(pose_gn_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
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
    err = cudaLaunchKernelEx(&cfg, pose_gn_kernel, T_init, xw, uv, valid, cam,
                             depth, bf_ptr, n, chunk, iters, n_wide, gate0,
                             final_gate, huber, chi2_gate, T_prior,
                             prior_weight, T_out, inliers);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
