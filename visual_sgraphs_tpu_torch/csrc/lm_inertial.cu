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
// priors), inertial/factors.py:58-114, and their cost (solve.py:69); and
// the whitening both take, the reference's jax.vmap(_sqrt_info) once a
// problem (vi_ba.py:171, init.py:115).
//
// What bounds it here: latency.  The VI BA has 9 edges (24 tangent
// directions each) and 18 walk rows, the initialisation up to 63 edges
// (15 directions); a residual is ~2000 float64 flops a direction, so the
// work is a few microseconds of one SM's float64 rate, and the time is the
// longest dependent chain: one edge's residual.
//
// Design, three entries:
// - ``plan``, once a solve: a warp an edge writes the edge's whitening
//   W = L^-1 (L L^T = cov + 1e-8 I, the identity where not finite) into an
//   (E, 81) float64 table, one row of L and then one column of W a lane
//   (imu.cuh::sqrt_info_warp); one more CTA indexes the valid edges (the
//   valid list in edge order, and for each row of the per-slot families
//   the valid edges that touch it, in edge order).
// - ``rows``, one cluster of 8 CTAs of 8 warps: a warp an edge (64 edges a
//   round, more loop), lane l evaluates the whitened 9-row residual in
//   float64 dual numbers seeded on the edge's tangent direction l
//   (imu.cuh's residual, shared with K20; the retractions exp(xi) T for
//   the poses, q so3_exp([d, 0]) for the gravity direction, s exp(d) for
//   the scale), so lane l holds column l of the Jacobian, what jax.jacfwd
//   computes; the warp stages J, w J^T r and the IRLS weight w = min(1,
//   9 / sqrt(chi2)) for imu_factor, 1 for imu_factor_gs (as the
//   engine's) in a float64 scratch an edge.  After a cluster barrier each
//   entry of H and g is summed in one fixed order and written once: a
//   warp an H row walks the row variable's edges in order, adding each
//   edge's w J^T J terms (formed from the staged J) at the edge's columns
//   in a shared-memory row, then the bias walks' (closed form, +-info); a
//   thread a g entry likewise; the initialisation's shared rows (biases,
//   gravity direction, scale) sum their shared columns over every edge
//   by lane-strided partial sums and a fixed shuffle tree, and take their
//   other columns from the per-slot rows (w J^T J is formed bitwise
//   symmetric), with the bias priors last.  No atomics: H and g are
//   bitwise equal from launch to launch.  The VI BA adds into K22a's H and
//   g (entries no edge touches are left alone); the initialisation writes
//   every entry (no memset).
// - ``cost``, one CTA: a thread an edge evaluates the value-only residual
//   and its Huber cost (and the edge's walks); a warp tree and the warps
//   in order sum them, with the priors, into the cost with one plain add.
//
// Precision, chosen by measurement: the duals, W and the sums are float64
// (lie.cuh's DualD).  On a real window of ``inertial_slice`` (NVIDIA H100
// 80GB HBM3, 700.00 W) the float32 twin's H is 1.7e-5 and its g 3.1e-5 off
// the float64 twin, each entry scaled by sqrt(H_ii H_jj)
// (``selfcheck.check_lm_inertial`` prints both on every run), against
// 1.7e-7 / 2.0e-6 for the first (one-block) design of this kernel.
#include <cooperative_groups.h>

#include "imu.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;  // CTAs of the rows launch
constexpr int GWARPS = CLUSTER * WARPS;
constexpr int COST_THREADS = 128;
constexpr int WCOLS = 256;  // columns of an H row a warp sums at once
constexpr int EB = 2;  // edges of an H row whose terms are loaded at once
constexpr int NS = 9;  // the initialisation's shared columns
constexpr int POSE = 0, VEL = 1, BG = 2, BA = 3, GDIR = 4, SCALE = 5;

}  // namespace

// The constant arguments of a solve (lm_kernels.InertialPlan keeps one,
// filled once by the wrapper; each call passes the six value tables).
struct ImuSolve {
    const float* pre;     // (E, 143) packed preintegrations
    const int* edge;      // (E, 2) rows (i, j)
    const float* Tbc;     // (7,)
    const float* poses;   // (n, 7) constant poses (initialisation)
    const float* info_g;  // (E,) walk information (VI BA)
    const float* info_a;
    const double* W;      // (E, 81) the plan's whitening
    const int* rptr;      // (n + 1,) the plan's row index ...
    const int* redge;     // (2E,) ... of valid edges
    const int* vedge;     // (E,) valid edges in order
    const int* nvalid;    // (1,)
    double* jac;          // (E, 9, nd) scratch: each edge's Jacobian
    double* grd;          // (E, nd + 1) scratch: w J^T r, then w
    int E, R, gs, D;  // edges, slot rows, initialisation (1) or VI BA
                      // (0), columns
    int ix;           // ints of the edge index staged in shared memory
    float prior;
    int off[6];  // column offset of each family, -1 absent
};

namespace {

struct ImuArgs {
    ImuSolve s;
    const float* val[6];
};

// the tangent dimension of a family
__device__ __forceinline__ int tangent(int fam) {
    return fam == POSE ? 6 : fam == GDIR ? 2 : fam == SCALE ? 1 : 3;
}

// exp(d) . T of a constant pose
__device__ void pose_retract(const float* T0, const DualD* d, DualD* out) {
    DualD E[7], P0[7];
    for (int k = 0; k < 7; ++k) P0[k] = mkdd(T0[k]);
    se3_exp(d, E);
    se3_mul(E, P0, out);
}

// The whitened residual of edge ``e`` (its packed preintegration ``pre``
// and whitening ``W``) in dual numbers seeded on direction ``lane`` (none
// when lane < 0 or past the edge's directions);
// directions: VI [pose_i 6 | pose_j 6 | vel_i 3 | vel_j 3 | bg_j 3 |
// ba_j 3], initialisation [vel_i 3 | vel_j 3 | bg 3 | ba 3 | gdir 2 |
// scale 1]
__device__ void edge_residual(const ImuArgs& a, int e, int lane,
                              const float* pre, const double* W, DualD* r) {
    const ImuSolve& s = a.s;
    const int i = s.edge[2 * e], j = s.edge[2 * e + 1];
    auto seed = [&](int l) { return mkdd(0.0, l == lane ? 1.0 : 0.0); };
    DualD Ti[7], Tj[7], vi[3], vj[3], bg[3], ba[3], g[3], sc;
    int l0 = 0;
    if (s.gs) {
        for (int k = 0; k < 7; ++k) {
            Ti[k] = mkdd(s.poses[7 * i + k]);
            Tj[k] = mkdd(s.poses[7 * j + k]);
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
    const int brow = s.gs ? 0 : j;
    for (int k = 0; k < 3; ++k) {
        vi[k] = (double)a.val[VEL][3 * i + k] + seed(l0 + k);
        vj[k] = (double)a.val[VEL][3 * j + k] + seed(l0 + 3 + k);
        bg[k] = (double)a.val[BG][3 * brow + k] + seed(l0 + 6 + k);
        ba[k] = (double)a.val[BA][3 * brow + k] + seed(l0 + 9 + k);
    }
    if (s.gs) {
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
        sc = (double)a.val[SCALE][0] * s_exp(seed(14));
    } else {
        g[0] = mkdd(0.0);
        g[1] = mkdd(0.0);
        g[2] = mkdd(-imu::GRAVITY);
        sc = mkdd(1.0);
    }
    DualD Tbc[7];
    for (int k = 0; k < 7; ++k) Tbc[k] = mkdd(s.Tbc[k]);
    imu::residual(pre, W, Ti, Tj, vi, vj, bg, ba, g, sc, Tbc, r);
}

__device__ double imu_cost(const ImuSolve& s, double chi2) {
    if (s.gs || chi2 <= 81.0) return chi2;
    return 18.0 * sqrt(fmax(chi2, 1e-12)) - 81.0;
}

// a column of the reduced layout: family, row, component, and its
// direction in an edge whose i (``di``) or j (``dj``) is its row, -1 where
// none (the initialisation's biases, gravity direction and scale, shared
// by every edge, have ``di`` in every edge):
//   VI [pose_i 6 | pose_j 6 | vel_i 3 | vel_j 3 | bg_j 3 | ba_j 3],
//   initialisation [vel_i 3 | vel_j 3 | bg 3 | ba 3 | gdir 2 | scale 1]
struct Col {
    int fam, row, k, di, dj;
};

__device__ Col decode(const ImuSolve& s, int c) {
    int fam = 0;
    for (int f = 0; f < 6; ++f) {
        if (s.off[f] >= 0 && c >= s.off[f]) fam = f;
    }
    const int t = tangent(fam), rel = c - s.off[fam], k = rel % t;
    Col col{fam, rel / t, k, -1, -1};
    if (s.gs) {
        col.di = fam == VEL ? k : fam == BG ? 6 + k : fam == BA ? 9 + k
               : fam == GDIR ? 12 + k : 14;
        col.dj = fam == VEL ? 3 + k : -1;
    } else {
        col.di = fam == POSE ? k : fam == VEL ? 12 + k : -1;
        col.dj = fam == POSE ? 6 + k : fam == VEL ? 15 + k
               : fam == BG ? 18 + k : 21 + k;
    }
    return col;
}

// the plan's edge index, in shared memory when it fits (``ImuSolve.ix``)
struct Ix {
    const int* edge;   // (E, 2)
    const int* vedge;  // valid edges in order
    const int* rptr;   // (R + 1,)
    const int* redge;  // each row's valid edges in order
    int nv;
};

// the valid edges that hold per-slot column ``c``'s variable, in edge
// order
__device__ __forceinline__ void col_edges(const Ix& ix, const Col& c,
                                          const int*& list, int& n) {
    const int lo = ix.rptr[c.row];
    list = ix.redge + lo;
    n = ix.rptr[c.row + 1] - lo;
}

// per-slot column ``c``'s directions in edge (i, j), in the order i, j
// (both only when i == j), -1 where none
__device__ __forceinline__ void col_dirs(const Col& c, int i, int j,
                                         int& d1, int& d2) {
    d1 = c.row == i ? c.di : -1;
    d2 = c.row == j ? c.dj : -1;
}

// a bias walk's coefficient of column ``c`` in edge (i, j): the residual
// is b_j - b_i (VI BA)
__device__ __forceinline__ double walk_coef(const Col& c, int i, int j) {
    return (double)((c.row == j) - (c.row == i));
}

__device__ __forceinline__ bool bias(int fam) {
    return fam == BG || fam == BA;
}

__device__ __forceinline__ const float* walk_info(const ImuSolve& s,
                                                  int fam) {
    return fam == BG ? s.info_g : s.info_a;
}

// Every entry of H and g is summed over the valid edges that hold its
// variables, in edge order (each edge's staged terms, then its walk), then
// the prior, and written once.

// The reduced column of direction ``l`` of edge (i, j)
__device__ __forceinline__ int dir_col(const ImuSolve& s, int l, int i,
                                       int j) {
    if (!s.gs) {
        if (l < 6) return s.off[POSE] + 6 * i + l;
        if (l < 12) return s.off[POSE] + 6 * j + (l - 6);
        l -= 12;
        if (l < 3) return s.off[VEL] + 3 * i + l;
        if (l < 6) return s.off[VEL] + 3 * j + (l - 3);
        return s.off[l < 9 ? BG : BA] + 3 * j + (l - 6) % 3;
    }
    if (l < 3) return s.off[VEL] + 3 * i + l;
    if (l < 6) return s.off[VEL] + 3 * j + (l - 3);
    if (l < 12) return s.off[l < 9 ? BG : BA] + (l - 6) % 3;
    return l < 14 ? s.off[GDIR] + (l - 12) : s.off[SCALE];
}

// w J^T J of edge ``e`` at directions (la, lb): w sum_k J[k][lb] J[k][la]
// (bitwise symmetric: the products' operands only swap)
__device__ __forceinline__ double jtj(const ImuSolve& s, int nd, int e,
                                      int la, int lb) {
    const double* J = s.jac + (size_t)e * 9 * nd;
    double h = 0.0;
#pragma unroll
    for (int k = 0; k < 9; ++k) h += J[k * nd + lb] * J[k * nd + la];
    return s.grd[(size_t)e * (nd + 1) + nd] * h;
}

// whether direction ``l`` belongs to the edge's j row (else its i row,
// or a variable every edge shares: ``Col::di``)
__device__ __forceinline__ bool j_dir(const ImuSolve& s, int l) {
    return s.gs ? l >= 3 && l < 6 : (l >= 6 && l < 12) || l >= 15;
}

// Row c1 of H with a per-slot row variable, one warp, through a
// shared-memory row of WCOLS columns at a time: for each of c1's edges in
// order, for each of c1's directions in it (i, then j), its w J^T J row
// is added lane by lane at the columns of the edge's i directions, then
// of its j directions (an entry's terms in the order (a_i, b_i), (a_i,
// b_j), (a_j, b_i), (a_j, b_j)), then the walk's.  ``buf`` / ``hit``: the
// warp's row and flags.
__device__ void h_row(const ImuSolve& s, const Ix& ix, int nd, int c1,
                      int lane, double* __restrict__ buf,
                      uint8_t* __restrict__ hit, double* __restrict__ H,
                      int zero) {
    const int D = s.D;
    const Col a = decode(s, c1);
    const int* list;
    int n;
    col_edges(ix, a, list, n);
    if (!zero && n == 0) return;
    const bool walk = !s.gs && bias(a.fam);
    double* row = H + (size_t)c1 * D;
    for (int w0 = 0; w0 < D; w0 += WCOLS) {
        const int w1 = min(D, w0 + WCOLS);
        // the entries added to, read before the edges' terms
        double old[WCOLS / 32];
#pragma unroll
        for (int x = 0; x < WCOLS / 32; ++x) {
            const int k = lane + 32 * x;
            old[x] = !zero && k < w1 - w0 ? row[w0 + k] : 0.0;
            buf[k] = 0.0;
            hit[k] = 0;
        }
        __syncwarp();
        for (int q0 = 0; q0 < n; q0 += EB) {
            // EB edges' terms loaded at once, then added in edge order
            int ev[EB], iv[EB], jv[EB], c2v[EB], ad[EB][2];
            double t[EB][2];
#pragma unroll
            for (int b = 0; b < EB; ++b) {
                const int q = min(q0 + b, n - 1);
                ev[b] = list[q];
                iv[b] = ix.edge[2 * ev[b]];
                jv[b] = ix.edge[2 * ev[b] + 1];
                col_dirs(a, iv[b], jv[b], ad[b][0], ad[b][1]);
                const int c2 =
                    lane < nd ? dir_col(s, lane, iv[b], jv[b]) - w0 : -1;
                c2v[b] = c2 >= 0 && c2 < w1 - w0 ? c2 : -1;
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    t[b][u] = c2v[b] >= 0 && ad[b][u] >= 0
                                  ? jtj(s, nd, ev[b], ad[b][u], lane)
                                  : 0.0;
                }
            }
            const bool jl = j_dir(s, lane);
#pragma unroll
            for (int b = 0; b < EB; ++b) {
                if (q0 + b >= n) break;
                const int c2 = c2v[b];
                for (int u = 0; u < 2; ++u) {
                    if (ad[b][u] < 0) continue;
                    for (int role = 0; role < 2; ++role) {
                        if (c2 >= 0 && jl == (role == 1)) {
                            buf[c2] += t[b][u];
                            hit[c2] = 1;
                        }
                        __syncwarp();
                    }
                }
                const int i = iv[b], j = jv[b];
                const double ca = walk ? walk_coef(a, i, j) : 0.0;
                if (ca != 0.0 && lane < 2) {
                    // the walk's b_i (lane 0) and b_j (lane 1) columns
                    const int r = lane == 0 ? i : j;
                    const int cw = s.off[a.fam] + 3 * r + a.k - w0;
                    if (cw >= 0 && cw < w1 - w0) {
                        buf[cw] += (double)walk_info(s, a.fam)[ev[b]] * ca *
                                   (lane == 0 ? -1.0 : 1.0);
                        hit[cw] = 1;
                    }
                }
                __syncwarp();
            }
        }
#pragma unroll
        for (int x = 0; x < WCOLS / 32; ++x) {
            const int k = lane + 32 * x;
            if (k >= w1 - w0 || !(zero || hit[k])) continue;
            const double v = zero ? buf[k] : old[x] + buf[k];
            row[w0 + k] = v;
            // the initialisation's shared rows take their per-slot
            // columns from here (``jtj`` is bitwise symmetric)
            if (s.gs && w0 + k >= s.off[BG]) {
                double* h = H + (size_t)(w0 + k) * D + c1;
                *h = zero ? v : *h + buf[k];
            }
        }
        __syncwarp();
    }
}

// The initialisation's shared columns (bg 3, ba 3, gdir 2, scale 1: the
// layout's last NS columns, directions 6 .. 14 of every edge) of a
// shared row ``c1`` of H (``gvec`` false) or of g (true), one warp: lane
// l sums the staged terms of valid edges l, l + 32, ... in order, a fixed
// shuffle tree adds the lanes (lane 0's sum is taken), then the prior.
__device__ void shared_sums(const ImuArgs& args, const Ix& ix, int c1,
                            bool gvec, int lane, double* __restrict__ out,
                            int zero) {
    const ImuSolve& s = args.s;
    const int da = gvec ? 0 : decode(s, c1).di;
    double part[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) part[m] = 0.0;
    for (int p = lane; p < ix.nv; p += 32) {
        const int e = ix.vedge[p];
#pragma unroll
        for (int m = 0; m < NS; ++m) {
            part[m] += gvec ? s.grd[(size_t)e * 16 + 6 + m]
                            : jtj(s, 15, e, da, 6 + m);
        }
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) {
        for (int off = 16; off > 0; off >>= 1) {
            part[m] += __shfl_xor_sync(0xffffffffu, part[m], off);
        }
        part[m] = __shfl_sync(0xffffffffu, part[m], 0);
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) {
        if (lane != m) continue;
        const int c = s.off[BG] + m;
        const int fam = m < 3 ? BG : m < 6 ? BA : -1;
        double v = part[m];
        if (fam >= 0 && (gvec || c == c1)) {
            v += gvec ? (double)s.prior * args.val[fam][m % 3]
                      : (double)s.prior;
        }
        double* o = gvec ? out + c : out + (size_t)c1 * s.D + c;
        if (zero) {
            *o = v;
        } else {
            *o += v;
        }
    }
}

// g[c] of a per-slot column, one thread, as H (its staged w J^T r terms i
// then j, its walk)
__device__ void g_entry(const ImuArgs& args, const Ix& ix, int nd, int c,
                        double* __restrict__ g, int zero) {
    const ImuSolve& s = args.s;
    const Col col = decode(s, c);
    const int* list;
    int n;
    col_edges(ix, col, list, n);
    const float* v = args.val[col.fam];
    const bool walk = !s.gs && bias(col.fam);
    double sum = 0.0;
    bool any = false;
#pragma unroll 4
    for (int q = 0; q < n; ++q) {
        const int e = list[q];
        const int i = ix.edge[2 * e], j = ix.edge[2 * e + 1];
        int d1, d2;
        col_dirs(col, i, j, d1, d2);
        const double* grd = s.grd + (size_t)e * (nd + 1);
        sum += d1 >= 0 ? grd[d1] : 0.0;
        sum += d2 >= 0 ? grd[d2] : 0.0;
        any = any || d1 >= 0 || d2 >= 0;
        if (walk) {
            const double cc = walk_coef(col, i, j);
            if (cc != 0.0) {
                const double res =
                    (double)v[3 * j + col.k] - (double)v[3 * i + col.k];
                sum += (double)walk_info(s, col.fam)[e] * cc * res;
                any = true;
            }
        }
    }
    if (zero) {
        g[c] = sum;
    } else if (any) {
        g[c] += sum;
    }
}

// edge ``e``'s whitening and packed preintegration into a warp's
// shared memory
__device__ __forceinline__ void load_edge(const ImuSolve& s, int e, int lane,
                                          double* W, float* pre) {
    for (int k = lane; k < 81; k += 32) W[k] = s.W[81 * e + k];
    for (int k = lane; k < imu::P; k += 32) pre[k] = s.pre[imu::P * e + k];
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
lm_inertial_rows_kernel(const __grid_constant__ ImuArgs a,
                        double* __restrict__ H, double* __restrict__ g,
                        int zero) {
    // phase 1's whitening and preintegration a warp, phase 2's rows
    __shared__ union {
        struct {
            double W[WARPS][81];
            float pre[WARPS][imu::P];
        } e;
        struct {
            double row[WARPS][WCOLS];
            uint8_t hit[WARPS][WCOLS];
        } r;
    } sh;
    extern __shared__ int ix_sh[];
    const ImuSolve& s = a.s;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gw = blockIdx.x * WARPS + warp;
    const int nd = s.gs ? 15 : 24, D = s.D;
    // the first edge (-1 past the valid ones) is read and loaded beside
    // the count and the index
    int e = gw < s.E ? s.vedge[gw] : -1;
    if (e >= 0) load_edge(s, e, lane, sh.e.W[warp], sh.e.pre[warp]);
    Ix ix{s.edge, s.vedge, s.rptr, s.redge, *s.nvalid};
    if (s.ix) {
        // [edge 2E | vedge E | rptr R + 1 | redge 2E]
        const int n_e = 2 * s.E, n_v = s.E, n_r = s.R + 1;
        for (int k = threadIdx.x; k < s.ix; k += THREADS) {
            ix_sh[k] = k < n_e ? s.edge[k]
                     : k < n_e + n_v ? s.vedge[k - n_e]
                     : k < n_e + n_v + n_r ? s.rptr[k - n_e - n_v]
                                           : s.redge[k - n_e - n_v - n_r];
        }
        __syncthreads();
        ix.edge = ix_sh;
        ix.vedge = ix_sh + n_e;
        ix.rptr = ix.vedge + n_v;
        ix.redge = ix.rptr + n_r;
    }
    // every valid edge's w J^T J and w J^T r, a warp an edge
    for (int p = gw; p < ix.nv; p += GWARPS) {
        if (p != gw) {
            e = ix.vedge[p];
            load_edge(s, e, lane, sh.e.W[warp], sh.e.pre[warp]);
        }
        __syncwarp();
        DualD r[9];
        edge_residual(a, e, lane < nd ? lane : -1, sh.e.pre[warp],
                      sh.e.W[warp], r);
        double chi2 = 0.0;
        for (int k = 0; k < 9; ++k) chi2 += r[k].v * r[k].v;
        const double w =
            s.gs ? 1.0 : fmin(9.0 / sqrt(fmax(chi2, 1e-12)), 1.0);
        // the Jacobian (column l from lane l), w J^T r and w
        double* jac = s.jac + (size_t)e * 9 * nd;
        double* grd = s.grd + (size_t)e * (nd + 1);
        if (lane < nd) {
            double gsum = 0.0;
            for (int k = 0; k < 9; ++k) {
                jac[k * nd + lane] = r[k].d;
                gsum += r[k].d * r[k].v;
            }
            grd[lane] = w * gsum;
        }
        if (lane == 0) grd[nd] = w;
        __syncwarp();
    }
    __threadfence();
    cg::this_cluster().sync();
    // g a thread an entry, then H a warp a row; the initialisation's
    // shared entries of g and rows of H a warp each
    const int shared0 = s.gs ? s.off[BG] : D;
    for (int c = blockIdx.x * THREADS + threadIdx.x; c < shared0;
         c += CLUSTER * THREADS) {
        g_entry(a, ix, nd, c, g, zero);
    }
    for (int t = gw; t < D + (s.gs ? 1 : 0); t += GWARPS) {
        if (t == D) {
            shared_sums(a, ix, -1, true, lane, g, zero);
        } else if (t >= shared0) {
            shared_sums(a, ix, t, false, lane, H, zero);
        } else {
            h_row(s, ix, nd, t, lane, sh.r.row[warp], sh.r.hit[warp], H,
                  zero);
        }
    }
}

__global__ void __launch_bounds__(COST_THREADS)
lm_inertial_cost_kernel(const __grid_constant__ ImuArgs a,
                        double* __restrict__ cost, int zero) {
    __shared__ double part[COST_THREADS / 32];
    const ImuSolve& s = a.s;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nv = *s.nvalid;
    double acc = 0.0;
    for (int p = threadIdx.x; p < nv; p += COST_THREADS) {
        const int e = s.vedge[p];
        DualD r[9];
        edge_residual(a, e, -1, s.pre + imu::P * e, s.W + 81 * e, r);
        double chi2 = 0.0;
        for (int k = 0; k < 9; ++k) chi2 += r[k].v * r[k].v;
        acc += imu_cost(s, chi2);
        if (!s.gs) {
            const int i = s.edge[2 * e], j = s.edge[2 * e + 1];
            for (int fam = BG; fam <= BA; ++fam) {
                double s2 = 0.0;
                for (int c = 0; c < 3; ++c) {
                    const double d = (double)a.val[fam][3 * j + c] -
                                     (double)a.val[fam][3 * i + c];
                    s2 += d * d;
                }
                acc += (double)walk_info(s, fam)[e] * s2;
            }
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = 0.0;
        for (int w = 0; w < COST_THREADS / 32; ++w) total += part[w];
        if (s.gs) {
            for (int fam = BG; fam <= BA; ++fam) {
                double s2 = 0.0;
                for (int c = 0; c < 3; ++c) {
                    s2 += (double)a.val[fam][c] * (double)a.val[fam][c];
                }
                total += (double)s.prior * s2;
            }
        }
        *cost = zero ? total : *cost + total;
    }
}

// The plan: blocks 0 .. ceil(E / 8) - 1 a warp an edge's W; the last
// block the edge index (edges with a row outside [0, R) are left out, as
// invalid ones are).
__global__ void __launch_bounds__(THREADS)
lm_inertial_plan_kernel(const float* __restrict__ pre,
                        const int* __restrict__ edge,
                        const uint8_t* __restrict__ valid, int E, int R,
                        double* __restrict__ W, int* __restrict__ rptr,
                        int* __restrict__ redge, int* __restrict__ vedge,
                        int* __restrict__ nvalid) {
    __shared__ int wsum[WARPS];
    __shared__ int carry;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (blockIdx.x + 1 < gridDim.x) {
        const int e = blockIdx.x * WARPS + warp;
        if (e >= E) return;
        double Wc[9];
        const bool ok = imu::sqrt_info_warp(pre + imu::P * e + imu::O_COV,
                                            lane, Wc);
        if (lane < 9) {
            for (int r = 0; r < 9; ++r) {
                W[81 * e + 9 * r + lane] =
                    ok ? Wc[r] : (r == lane ? 1.0 : 0.0);
            }
        }
        return;
    }
    auto usable = [&](int e) {
        const int i = edge[2 * e], j = edge[2 * e + 1];
        return valid[e] && i >= 0 && i < R && j >= 0 && j < R;
    };
    // the valid edges in order (warp 0, a ballot a chunk of 32)
    if (warp == 0) {
        int n = 0;
        for (int base = 0; base < E; base += 32) {
            const int e = base + lane;
            const bool ok = e < E && usable(e);
            const unsigned b = __ballot_sync(0xffffffffu, ok);
            if (ok) vedge[n + __popc(b & ((1u << lane) - 1u))] = e;
            n += __popc(b);
        }
        for (int p = n + lane; p < E; p += 32) vedge[p] = -1;
        if (lane == 0) *nvalid = n;
    }
    // each row's edges: counted, prefix-summed a chunk of THREADS rows at
    // a time, then listed by the row's thread in edge order
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < R; base += THREADS) {
        const int r = base + threadIdx.x;
        int cnt = 0;
        if (r < R) {
            for (int e = 0; e < E; ++e) {
                cnt += usable(e) && (edge[2 * e] == r || edge[2 * e + 1] == r);
            }
        }
        int incl = cnt;
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        int before = carry;
        for (int w = 0; w < warp; ++w) before += wsum[w];
        const int start = before + incl - cnt;
        if (r < R) {
            rptr[r] = start;
            int n = start;
            for (int e = 0; e < E; ++e) {
                if (usable(e) && (edge[2 * e] == r || edge[2 * e + 1] == r)) {
                    redge[n++] = e;
                }
            }
        }
        __syncthreads();
        if (threadIdx.x == THREADS - 1) carry = before + incl;
        __syncthreads();
    }
    if (threadIdx.x == 0) rptr[R] = carry;
    for (int p = carry + threadIdx.x; p < 2 * E; p += THREADS) redge[p] = -1;
}

ImuArgs make_args(const ImuSolve* s, const float* const* vals) {
    ImuArgs a;
    a.s = *s;
    for (int k = 0; k < 6; ++k) a.val[k] = vals[k];
    return a;
}

}  // namespace

// pre (E, 143) f32 packed preintegrations, edge (E, 2) i32 rows (i, j),
// valid (E,) u8; R: the rows of the per-slot families.  Writes W (E, 81)
// f64, the row index rptr (R + 1,) / redge (2E,) (-1 past rptr[R]) and
// the valid edges vedge (E,) (-1 past the count) / nvalid (1,) i32.
VSG_API int vsg_lm_inertial_plan(const float* pre, const int* edge,
                                 const uint8_t* valid, int E, int R,
                                 double* W, int* rptr, int* redge,
                                 int* vedge, int* nvalid,
                                 cudaStream_t stream) {
    const int blocks = (E + WARPS - 1) / WARPS + 1;
    lm_inertial_plan_kernel<<<blocks, THREADS, 0, stream>>>(
        pre, edge, valid, E, R, W, rptr, redge, vedge, nvalid);
    return (int)cudaGetLastError();
}

// s: the solve's constants; vals: host array of the six reduced families'
// device tables [pose (7), vel, bg, ba (3), gdir (4), scale (1)] (null
// absent).  H (D, D) and g (D,) f64: written whole when ``zero``, else
// H += w J^T J, g += w J^T r on the entries the rows touch.
VSG_API int vsg_lm_inertial_assemble(const ImuSolve* s,
                                     const float* const* vals, double* H,
                                     double* g, int zero,
                                     cudaStream_t stream) {
    lm_inertial_rows_kernel<<<CLUSTER, THREADS, sizeof(int) * s->ix,
                              stream>>>(make_args(s, vals), H, g, zero);
    return (int)cudaGetLastError();
}

// As vsg_lm_inertial_assemble; cost () f64 = (``zero``) or += the
// factors' robust cost.
VSG_API int vsg_lm_inertial_cost(const ImuSolve* s, const float* const* vals,
                                 double* cost, int zero,
                                 cudaStream_t stream) {
    lm_inertial_cost_kernel<<<1, COST_THREADS, 0, stream>>>(
        make_args(s, vals), cost, zero);
    return (int)cudaGetLastError();
}
