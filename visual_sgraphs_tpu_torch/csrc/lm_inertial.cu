// K22b: the inertial rows of the LM engine's dense system, and their cost.
//
// Replaces, on the card, the generic linearisation and scatter
// (visual_sgraphs_tpu/optim/solve.py:85::_assemble over
// optim/graph.py::linearize_batch) of the inertial factors of
// inertial/vi_ba.py:166-211 (the VI local BA: imu_factor with Huber 9.0
// over pose_i, pose_j, vel_i, vel_j, bias_g, bias_a, gravity the constant
// (0, 0, -9.81), and the gyro / accel bias walks of information
// 1 / (walk^2 dt)) and of inertial/init.py:107-160 (the initialisation:
// imu_factor_gs over vel_i, vel_j, the shared biases, the 2-dof gravity
// direction and the 1-dof scale, with fixed poses, and the two bias
// priors), inertial/factors.py:58-114, and their cost (solve.py:69).
//
// What bounds it here: latency and precision, not throughput.  The VI BA
// has at most 9 edges (24 tangent directions each) and 18 walk rows, the
// initialisation at most 63 edges (15 directions); a residual is ~2000
// flops a direction.
//
// Design: one block.  A warp takes an edge, lane l evaluates the whitened
// 9-row residual in dual numbers seeded on the edge's tangent direction l
// (imu.cuh's residual, shared with K20; the retractions exp(xi) T for the
// poses, q so3_exp([d, 0]) for the gravity direction, s exp(d) for the
// scale), so lane l holds column l of the Jacobian, what jax.jacfwd
// computes; the warp forms w J^T J by shuffles and adds it and w J^T r
// into H, g with float64 atomics (edges share variables).  The IRLS weight
// is w = valid * min(1, 9 / sqrt(chi2)) for imu_factor, valid for
// imu_factor_gs, as the engine's.  The bias walks and priors are linear
// and are added in closed form.  The cost entry evaluates the same
// residuals without seeds.
//
// Precision, chosen by measurement: the duals, the whitening (the inverse
// Cholesky factor of the preintegration covariance, in float64 as K20
// computes it) and the sums are float64 (lie.cuh's DualD).  On a real
// window of ``inertial_slice`` (NVIDIA H100 80GB HBM3, 700.00 W) the
// float32 twin's H is 1.7e-5 and its g 3.1e-5 off the float64 twin, each
// entry scaled by sqrt(H_ii H_jj) (``selfcheck.check_lm_inertial`` prints
// both on every run), against 1.7e-7 / 2.0e-6 for this kernel; the rows
// are so few that float64 costs no measurable time.
#include "imu.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int POSE = 0, VEL = 1, BG = 2, BA = 3, GDIR = 4, SCALE = 5;

struct ImuArgs {
    const float* pre;      // (E, 143)
    const int* edge;       // (E, 2)
    const uint8_t* valid;  // (E,)
    int E;
    const float* Tbc;
    int gs;
    const float* poses;  // (n, 7) constant poses (gs)
    const float* info_g;
    const float* info_a;  // (E,) walk information (not gs)
    float prior;
    const float* val[6];
    int off[6];
};

// tangent directions of an edge: VI [pose_i 6 | pose_j 6 | vel_i 3 |
// vel_j 3 | bg 3 | ba 3], initialisation [vel_i 3 | vel_j 3 | bg 3 |
// ba 3 | gdir 2 | scale 1]
__device__ __forceinline__ int n_dirs(const ImuArgs& a) {
    return a.gs ? 15 : 24;
}

// the reduced column of direction ``l`` of edge (i, j)
__device__ int dir_col(const ImuArgs& a, int l, int i, int j) {
    const int brow = a.gs ? 0 : j;
    if (!a.gs) {
        if (l < 6) return a.off[POSE] + 6 * i + l;
        if (l < 12) return a.off[POSE] + 6 * j + (l - 6);
        l -= 12;
    }
    if (l < 3) return a.off[VEL] + 3 * i + l;
    if (l < 6) return a.off[VEL] + 3 * j + (l - 3);
    if (l < 9) return a.off[BG] + 3 * brow + (l - 6);
    if (l < 12) return a.off[BA] + 3 * brow + (l - 9);
    if (l < 14) return a.off[GDIR] + (l - 12);
    return a.off[SCALE];
}

// exp(d) . T of a constant pose
__device__ void pose_retract(const float* T0, const DualD* d, DualD* out) {
    DualD E[7], P0[7];
    for (int k = 0; k < 7; ++k) P0[k] = mkdd(T0[k]);
    se3_exp(d, E);
    se3_mul(E, P0, out);
}

// The whitened residual of edge ``e`` in dual numbers seeded on
// direction ``lane`` (none when lane < 0 or past the edge's directions).
__device__ void edge_residual(const ImuArgs& a, int e, int lane,
                              const double* W, DualD* r) {
    const int i = a.edge[2 * e], j = a.edge[2 * e + 1];
    auto seed = [&](int l) { return mkdd(0.0, l == lane ? 1.0 : 0.0); };
    DualD Ti[7], Tj[7], vi[3], vj[3], bg[3], ba[3], g[3], s;
    int l0 = 0;
    if (a.gs) {
        for (int k = 0; k < 7; ++k) {
            Ti[k] = mkdd(a.poses[7 * i + k]);
            Tj[k] = mkdd(a.poses[7 * j + k]);
        }
    } else {
        DualD di[6], dj[6];
        for (int k = 0; k < 6; ++k) {
            di[k] = seed(k);
            dj[k] = seed(6 + k);
        }
        pose_retract(a.val[POSE] + 7 * i, di, Ti);
        pose_retract(a.val[POSE] + 7 * j, dj, Tj);
        l0 = 12;
    }
    const int brow = a.gs ? 0 : j;
    for (int k = 0; k < 3; ++k) {
        vi[k] = (double)a.val[VEL][3 * i + k] + seed(l0 + k);
        vj[k] = (double)a.val[VEL][3 * j + k] + seed(l0 + 3 + k);
        bg[k] = (double)a.val[BG][3 * brow + k] + seed(l0 + 6 + k);
        ba[k] = (double)a.val[BA][3 * brow + k] + seed(l0 + 9 + k);
    }
    if (a.gs) {
        // gravity_from_quat(gdir_retract(q, d)), scale_retract(s, d)
        DualD q[4], dq[3], ex[4], qn[4], gz[3];
        for (int k = 0; k < 4; ++k) q[k] = mkdd(a.val[GDIR][k]);
        dq[0] = seed(12);
        dq[1] = seed(13);
        dq[2] = mkdd(0.0);
        so3_exp(dq, ex);
        quat_mul(q, ex, qn);
        quat_normalize(qn);
        gz[0] = mkdd(0.0);
        gz[1] = mkdd(0.0);
        gz[2] = mkdd(-imu::GRAVITY);
        quat_rot(qn, gz, g);
        s = (double)a.val[SCALE][0] * s_exp(seed(14));
    } else {
        g[0] = mkdd(0.0);
        g[1] = mkdd(0.0);
        g[2] = mkdd(-imu::GRAVITY);
        s = mkdd(1.0);
    }
    DualD Tbc[7];
    for (int k = 0; k < 7; ++k) Tbc[k] = mkdd(a.Tbc[k]);
    imu::residual(a.pre + imu::P * e, W, Ti, Tj, vi, vj, bg, ba, g, s, Tbc,
                  r);
}

// the edge's sqrt information into W (one lane), identity if not finite
__device__ void edge_sqrt_info(const ImuArgs& a, int e, double* W) {
    if (!imu::sqrt_info(a.pre + imu::P * e + imu::O_COV, W)) {
        for (int k = 0; k < 81; ++k) W[k] = k % 10 == 0 ? 1.0 : 0.0;
    }
}

__device__ double chi2_weight(const ImuArgs& a, double chi2) {
    return a.gs ? 1.0 : fmin(9.0 / sqrt(fmax(chi2, 1e-12)), 1.0);
}

__device__ double imu_cost(const ImuArgs& a, double chi2) {
    if (a.gs || chi2 <= 81.0) return chi2;
    return 18.0 * sqrt(fmax(chi2, 1e-12)) - 81.0;
}

__global__ void __launch_bounds__(THREADS)
lm_inertial_kernel(ImuArgs a, int D, double* __restrict__ H,
                   double* __restrict__ g) {
    __shared__ double Wsh[WARPS][81];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nd = n_dirs(a);
    for (int e = warp; e < a.E; e += WARPS) {
        if (!a.valid[e]) continue;
        if (lane == 0) edge_sqrt_info(a, e, Wsh[warp]);
        __syncwarp();
        DualD r[9];
        edge_residual(a, e, lane < nd ? lane : -1, Wsh[warp], r);
        double chi2 = 0.0, gs = 0.0;
        for (int k = 0; k < 9; ++k) {
            chi2 += r[k].v * r[k].v;
            gs += r[k].d * r[k].v;
        }
        const double w = chi2_weight(a, chi2);
        const int i = a.edge[2 * e], j = a.edge[2 * e + 1];
        const int col = lane < nd ? dir_col(a, lane, i, j) : 0;
        if (lane < nd && gs != 0.0) atomicAdd(&g[col], w * gs);
        for (int b = 0; b < nd; ++b) {
            double h = 0.0;
            for (int k = 0; k < 9; ++k) {
                h += r[k].d * __shfl_sync(0xffffffffu, r[k].d, b);
            }
            if (lane < nd && h != 0.0) {
                atomicAdd(&H[(size_t)col * D + dir_col(a, b, i, j)], w * h);
            }
        }
        __syncwarp();
    }
    // the linear rows: bias walks (VI) or bias priors (initialisation)
    if (!a.gs) {
        for (int t = threadIdx.x; t < a.E * 6; t += THREADS) {
            const int e = t / 6, fam = (t % 6) < 3 ? BG : BA, c = t % 3;
            if (!a.valid[e]) continue;
            const int i = a.edge[2 * e], j = a.edge[2 * e + 1];
            const double info = fam == BG ? a.info_g[e] : a.info_a[e];
            const int ci = a.off[fam] + 3 * i + c, cj = a.off[fam] + 3 * j + c;
            const double res = (double)a.val[fam][3 * j + c] -
                               (double)a.val[fam][3 * i + c];
            atomicAdd(&H[(size_t)ci * D + ci], info);
            atomicAdd(&H[(size_t)cj * D + cj], info);
            atomicAdd(&H[(size_t)ci * D + cj], -info);
            atomicAdd(&H[(size_t)cj * D + ci], -info);
            atomicAdd(&g[ci], -info * res);
            atomicAdd(&g[cj], info * res);
        }
    } else if (threadIdx.x < 6) {
        const int fam = threadIdx.x < 3 ? BG : BA, c = threadIdx.x % 3;
        const int col = a.off[fam] + c;
        atomicAdd(&H[(size_t)col * D + col], (double)a.prior);
        atomicAdd(&g[col], (double)a.prior * a.val[fam][c]);
    }
}

__global__ void __launch_bounds__(THREADS)
lm_inertial_cost_kernel(ImuArgs a, double* __restrict__ cost) {
    __shared__ double Wsh[WARPS][81];
    __shared__ double part[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double acc = 0.0;
    for (int e = warp; e < a.E; e += WARPS) {
        if (!a.valid[e]) continue;
        if (lane == 0) {
            edge_sqrt_info(a, e, Wsh[warp]);
            DualD r[9];
            edge_residual(a, e, -1, Wsh[warp], r);
            double chi2 = 0.0;
            for (int k = 0; k < 9; ++k) chi2 += r[k].v * r[k].v;
            acc += imu_cost(a, chi2);
        }
    }
    if (!a.gs) {
        for (int t = threadIdx.x; t < a.E * 2; t += THREADS) {
            const int e = t >> 1, fam = (t & 1) ? BA : BG;
            if (!a.valid[e]) continue;
            const int i = a.edge[2 * e], j = a.edge[2 * e + 1];
            double s2 = 0.0;
            for (int c = 0; c < 3; ++c) {
                const double d = (double)a.val[fam][3 * j + c] -
                                 (double)a.val[fam][3 * i + c];
                s2 += d * d;
            }
            acc += (fam == BG ? a.info_g[e] : a.info_a[e]) * s2;
        }
    } else if (threadIdx.x < 2) {
        const int fam = threadIdx.x == 0 ? BG : BA;
        double s2 = 0.0;
        for (int c = 0; c < 3; ++c) {
            s2 += (double)a.val[fam][c] * (double)a.val[fam][c];
        }
        acc += (double)a.prior * s2;
    }
    for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int w = 0; w < WARPS; ++w) s += part[w];
        atomicAdd(cost, s);
    }
}

ImuArgs make_args(const float* pre, const int* edge, const uint8_t* valid,
                  int E, const float* Tbc, int gs, const float* poses,
                  const float* info_g, const float* info_a, float prior,
                  const float* const* vals, const int* offs) {
    ImuArgs a;
    a.pre = pre;
    a.edge = edge;
    a.valid = valid;
    a.E = E;
    a.Tbc = Tbc;
    a.gs = gs;
    a.poses = poses;
    a.info_g = info_g;
    a.info_a = info_a;
    a.prior = prior;
    for (int k = 0; k < 6; ++k) {
        a.val[k] = vals[k];
        a.off[k] = offs[k];
    }
    return a;
}

}  // namespace

// pre (E, 143) f32 packed preintegrations, edge (E, 2) i32 rows (i, j),
// valid (E,) u8, Tbc (7,) f32; gs: 1 for the initialisation
// (imu_factor_gs, constant ``poses`` (n, 7), bias priors of information
// ``prior``), 0 for the VI BA (imu_factor, bias walks of information
// info_g / info_a (E,)).  vals / offs: host arrays of the six reduced
// families' device tables [pose (7), vel, bg, ba (3), gdir (4), scale
// (1)] and their column offsets (-1 absent).  H (D, D) and g (D,) f64:
// zeroed first when ``zero``, then H += w J^T J, g += w J^T r.
VSG_API int vsg_lm_inertial_assemble(
    const float* pre, const int* edge, const uint8_t* valid, int E,
    const float* Tbc, int gs, const float* poses, const float* info_g,
    const float* info_a, float prior, const float* const* vals,
    const int* offs, int D, double* H, double* g, int zero,
    cudaStream_t stream) {
    if (zero) {
        cudaError_t err = cudaMemsetAsync(
            H, 0, sizeof(double) * (size_t)D * D, stream);
        if (err == cudaSuccess) {
            err = cudaMemsetAsync(g, 0, sizeof(double) * D, stream);
        }
        if (err != cudaSuccess) return (int)err;
    }
    const ImuArgs a = make_args(pre, edge, valid, E, Tbc, gs, poses, info_g,
                                info_a, prior, vals, offs);
    lm_inertial_kernel<<<1, THREADS, 0, stream>>>(a, D, H, g);
    return (int)cudaGetLastError();
}

// As vsg_lm_inertial_assemble; cost () f64 += the factors' robust cost
// (zeroed first when ``zero``).
VSG_API int vsg_lm_inertial_cost(
    const float* pre, const int* edge, const uint8_t* valid, int E,
    const float* Tbc, int gs, const float* poses, const float* info_g,
    const float* info_a, float prior, const float* const* vals,
    const int* offs, double* cost, int zero, cudaStream_t stream) {
    if (zero) {
        const cudaError_t err =
            cudaMemsetAsync(cost, 0, sizeof(double), stream);
        if (err != cudaSuccess) return (int)err;
    }
    const ImuArgs a = make_args(pre, edge, valid, E, Tbc, gs, poses, info_g,
                                info_a, prior, vals, offs);
    lm_inertial_cost_kernel<<<1, THREADS, 0, stream>>>(a, cost);
    return (int)cudaGetLastError();
}
