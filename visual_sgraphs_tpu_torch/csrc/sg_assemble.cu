// K21: the scene-graph BA's reduced system, one launch an iteration.
//
// Replaces visual_sgraphs_tpu/optim/fast_ba.py:46::_assemble_dense over
// optim/graph.py:154::linearize_batch, and the lines that build S and rhs
// from it (:385-389), as fast_scenegraph_ba (:197) runs them every
// iteration: per item of five factor types (optim/factors.py:112, 128,
// 161, 172, 181) the whitened residual, its Jacobians by jax.jacfwd
// through each family's retraction at delta = 0 (se3_boxplus for keyframe
// and door poses, plane oplus for planes, + for room centres), the weight
// valid * min(1, huber / sqrt(max(chi2, 1e-12))), the dense (D, D) system
// H = sum w J_i^T J_j, g = sum w J_i^T r over
// [kf (L, 6) | plane (P, 3) | room (R, 3) | door (Dn, 6)], and then
// S = H with the landmark reduction's S_kf added into its keyframe block,
// rhs = [rhs_kf - g_kf | -g_rest].
//
//   type           rows  variables (tangent dims)     Huber
//   plane_kf        3    kf (6), plane (3)             2.79
//   plane_quadric   1    kf (6), plane (3)             1.96
//   room_4wall      3    room (3), 4 x plane (3)       1.0
//   room_2wall      3    room (3), 2 x plane (3)       1.0
//   door_room       3    door (6), room (3)            1.0
//
// What bounds it here: latency.  At the main path's shapes (Q = 1024
// plane observations, R = Dn = 16, D = 402) it reads ~100 KB of operands
// and writes the 646 KB of S once; each live item is a few hundred
// float64 flops per tangent direction, ~3 MFLOP when every item is live.
//
// Design, two entries:
// - ``plan``, once a BA call (the factor operands do not change between
//   its iterations), one CTA of 1024 threads for the lists: the live
//   items (any of the five types' valid flags) compacted in item order
//   [plane_kf Q | quadric Q | room4 R | room2 R | door Dn] (a warp a
//   contiguous range, counted by ballots); each variable's (item, slot)
//   entries in item order (a stable counting sort: a warp a contiguous
//   range, match_any ranks within it); the variable pairs (a <= b) that
//   some item couples, in index order, and for each its contributors
//   (n, si, sj) (live item n, slot si on a, slot sj on b) in (n, si, sj)
//   order, found by a warp walking the shorter of the two variables'
//   lists, and each contributor's position in that order; a (V, V) map
//   of the coupled pairs.  Beside it, CTAs of 128
//   threads compute each plane observation's chart rotation
//   (core/plane.py::normal_rotation, float64), which the plane-KF
//   residual's ominus takes on a constant plane.  No count is read back:
//   the system launch reads the plan's counts on the device.
// - ``system``, every iteration, one cooperative launch of as many
//   128-thread CTAs as are resident (at most one warp a live item):
//   1. each CTA stages the values in shared memory and computes every
//      plane's chart rotation and its oplus at delta = 0 once (a thread a
//      plane);
//   2. a warp a live item: lane l evaluates the residual in float64 dual
//      numbers (lie.cuh's DualD) seeded on the item's tangent direction l
//      (9 or 15 directions), through the same branches as the twin
//      (lie.cuh's exp / multiply, the plane chart, |.| and the sign /
//      magnitude selections of _room_pair_vec, the clamp under
//      plane_quadric's sqrt): each is a choice on the value that takes the
//      derivative of the chosen branch, which is what forward-mode AD
//      computes.  A room's lanes evaluate only their own wall's oplus in
//      dual numbers and take the other walls from the staged values (their
//      derivatives on that lane are zero); the float64 divisions of a
//      plane's normalisation go through one reciprocal.  Lane a then
//      holds column a of the whitened Jacobian (staged in shared memory
//      for the other lanes) and writes its rows of the item's blocks of
//      w J^T J (bitwise symmetric) and, on a diagonal pair, of w J^T r
//      (0 where the slots differ) at the blocks' contributor positions in
//      the plan's scratch;
//   3. every entry of S in a pair no item couples, and of rhs of a
//      variable no item touches, is written from S_kf / rhs_kf (or 0), by
//      the CTAs that hold no item when there are such;
//   4. a grid barrier (every CTA resident; a counter a group of 16 CTAs
//      and one for the groups; they return to zero);
//   5. a warp a coupled pair: each entry of its block is summed by one
//      lane over the pair's contributor blocks, which lie in order one
//      after the other (so the lanes stream them and the long lists of a
//      keyframe's diagonal block do not wait on dependent loads), in
//      float64, rounded once to float32, and written with its transpose
//      (diagonal blocks: the upper triangle, mirrored; S is exactly
//      symmetric); the diagonal pair's warp also sums the variable's g
//      entries.
//   No float atomics, memset, slice add or negation: S and rhs are
//   bitwise equal from launch to launch, and each is one device operation.
//   Slots of one item on one variable (two walls on one plane) each add
//   their blocks, as the twin's scatter does.
// Why float64: the Gij-quadric residual sqrt(pi^T G pi) cancels (G's
// entries are ~|p|^2, tens, while pi^T G pi is a mean squared distance,
// ~1e-4), so float32 loses ~3 digits there (the float32 twin's H is ~1e-3
// off the float64 one).
#include "lie.cuh"

namespace {

constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_WARPS = PLAN_THREADS / 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int BS = 36;  // doubles of a contributor's block (6 x 6 at most)
constexpr int GB = 6;   // doubles of a contributor's w J^T r (diagonal)
constexpr unsigned FULL = 0xffffffffu;

// the grid barrier: a counter per group of BAR_GROUP CTAs, the groups'
// counter, the generation
constexpr int BAR_GROUP = 16;
constexpr int BAR_MAX_GROUPS = 128;
__device__ unsigned g_sg_bar[BAR_MAX_GROUPS + 2];

// ---- item layout: [plane_kf Q | quadric Q | room4 R | room2 R | door Dn]

__host__ __device__ __forceinline__ int item_type(int i, int Q, int R) {
    return i < Q ? 0 : i < 2 * Q ? 1 : i < 2 * Q + R ? 2
         : i < 2 * Q + 2 * R ? 3 : 4;
}
__host__ __device__ __forceinline__ int type_base(int t, int Q, int R) {
    return t <= 1 ? t * Q : t <= 3 ? 2 * Q + (t - 2) * R : 2 * Q + 2 * R;
}
__host__ __device__ __forceinline__ int type_slots(int t) {
    return t == 2 ? 5 : t == 3 ? 3 : 2;
}
__host__ __device__ __forceinline__ int type_dirs(int t) {
    return t == 2 ? 15 : 9;
}
__host__ __device__ __forceinline__ int type_rows(int t) {
    return t == 1 ? 1 : 3;
}
// first tangent direction of slot s
__device__ __forceinline__ int slot_dir(int t, int s) {
    return (t == 2 || t == 3) ? 3 * s : (s == 0 ? 0 : 6);
}

struct Dims {
    int L, P, R, Dn, Q;
    __device__ int V() const { return L + P + R + Dn; }
    __device__ int NI() const { return 2 * Q + 2 * R + Dn; }
    __device__ int D() const { return 6 * L + 3 * P + 3 * R + 6 * Dn; }
    // first column and width of variable v
    __device__ int col(int v) const {
        return v < L ? 6 * v
             : v < L + P ? 6 * L + 3 * (v - L)
             : v < L + P + R ? 6 * L + 3 * P + 3 * (v - L - P)
             : 6 * L + 3 * P + 3 * R + 6 * (v - L - P - R);
    }
    __device__ int width(int v) const {
        return (v < L || v >= L + P + R) ? 6 : 3;
    }
    // the variable of column c
    __device__ int var_of(int c) const {
        const int op = 6 * L, orm = op + 3 * P, odr = orm + 3 * R;
        return c < op ? c / 6
             : c < orm ? L + (c - op) / 3
             : c < odr ? L + P + (c - orm) / 3
             : L + P + R + (c - odr) / 6;
    }
};

// Rz(azimuth) Ry(-elevation) of a constant normal, row-major
// (core/plane.py::normal_rotation): the cosines and sines of azimuth =
// atan2(v1, v0) and elevation = atan2(v2, |v01|) as the ratios they are
// (within an ulp of the trigonometric ones), the trigonometric ones where a
// ratio is 0 / 0
__device__ void normal_rotation(const float* vf, double* R) {
    const double v0 = vf[0], v1 = vf[1], v2 = vf[2];
    const double rxy = sqrt(v0 * v0 + v1 * v1);
    const double r = sqrt(v0 * v0 + v1 * v1 + v2 * v2);
    double ca, sa, ce, se;
    if (rxy > 0.0) {
        const double q = 1.0 / rxy;
        ca = v0 * q;
        sa = v1 * q;
    } else {
        const double az = atan2(v1, v0);
        ca = cos(az);
        sa = sin(az);
    }
    if (r > 0.0) {
        const double q = 1.0 / r;
        ce = rxy * q;
        se = v2 * q;
    } else {
        const double el = atan2(v2, rxy);
        ce = cos(el);
        se = sin(el);
    }
    R[0] = ca * ce;
    R[1] = -sa;
    R[2] = -ca * se;
    R[3] = sa * ce;
    R[4] = ca;
    R[5] = -sa * se;
    R[6] = se;
    R[7] = 0.0;
    R[8] = ce;
}

// ---------------------------------------------------------------- plan

struct PlanArgs {
    const int* ob_idx;
    const float* ob_coeffs;
    const uint8_t *ob_valid, *quad_valid;
    const int* room_idx;
    const uint8_t *room4_valid, *room2_valid;
    const int* door_idx;
    const uint8_t* door_valid;
    Dims d;
    int np_cap, ne_cap;
    int *live, *pairs, *pptr, *pent, *epos;
    uint8_t* pmap;
    double* rot;
    int* meta;
};

__device__ bool item_live(const PlanArgs& a, int i) {
    const int t = item_type(i, a.d.Q, a.d.R), k = i - type_base(t, a.d.Q,
                                                                a.d.R);
    const uint8_t* f[5] = {a.ob_valid, a.quad_valid, a.room4_valid,
                           a.room2_valid, a.door_valid};
    return f[t][k] != 0;
}

// the variable of slot s of item i
__device__ int slot_var(const PlanArgs& a, int i, int s) {
    const Dims& d = a.d;
    const int t = item_type(i, d.Q, d.R), k = i - type_base(t, d.Q, d.R);
    if (t <= 1) return s == 0 ? a.ob_idx[2 * k] : d.L + a.ob_idx[2 * k + 1];
    if (t <= 3) {
        return s == 0 ? d.L + d.P + a.room_idx[5 * k]
                      : d.L + a.room_idx[5 * k + s];
    }
    return s == 0 ? d.L + d.P + d.R + a.door_idx[2 * k]
                  : d.L + d.P + a.door_idx[2 * k + 1];
}

// Exclusive prefix of x over the block (PLAN_THREADS threads); every
// thread gets the block's total.  ``sw``: PLAN_WARPS + 1 shared ints.
__device__ int block_scan(int x, int* sw, int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = x;
    for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
    }
    if (lane == 31) sw[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int w = sw[lane];
        int wi = w;
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(FULL, wi, off);
            if (lane >= off) wi += v;
        }
        sw[lane] = wi - w;
        if (lane == 31) sw[PLAN_WARPS] = wi;
    }
    __syncthreads();
    const int out = sw[warp] + incl - x;
    total = sw[PLAN_WARPS];
    __syncthreads();
    return out;
}

// The indices i < n with pred(i), in order: warp w takes a contiguous
// range of them, counts it by ballots, the warps' counts are scanned and
// each warp hands its own to emit(position, i) in order.  Returns the
// count (every thread).
template <typename Pred, typename Emit>
__device__ int block_compact(int n, int* sw, Pred pred, Emit emit) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int span = (n + 32 * PLAN_WARPS - 1) / (32 * PLAN_WARPS) * 32;
    const int lo = warp * span, hi = min(n, lo + span);
    int cnt = 0;
    for (int b = lo; b < hi; b += 32) {
        cnt += __popc(__ballot_sync(FULL, b + lane < hi && pred(b + lane)));
    }
    int total;
    int pos = block_scan(lane == 0 ? cnt : 0, sw, total);
    pos = __shfl_sync(FULL, pos, 0);
    for (int b = lo; b < hi; b += 32) {
        const bool ok = b + lane < hi && pred(b + lane);
        const unsigned m = __ballot_sync(FULL, ok);
        if (ok) emit(pos + __popc(m & ((1u << lane) - 1u)), b + lane);
        pos += __popc(m);
    }
    return total;
}

// A warp: the contributors of pair (va, vb) over the shorter variable
// list (va's on ties): for each distinct item n in order, slots si on va
// and sj on vb in order, written to out[k] (when given) with k at
// epos[code].  Returns their count (every lane).
__device__ int walk_pair(const int* vptr, const int* vent, const int* ivar,
                         int va, int vb, int* out, int k0, int* epos) {
    const int lane = threadIdx.x & 31;
    const int la = vptr[va + 1] - vptr[va], lb = vptr[vb + 1] - vptr[vb];
    const int vw = lb < la ? vb : va;
    const int p0 = vptr[vw], p1 = vptr[vw + 1];
    int total = 0;
    for (int b = p0; b < p1; b += 32) {
        const int p = b + lane;
        int n = -1, na = 0, nb = 0;
        if (p < p1) {
            n = vent[p] / 5;
            if (p == p0 || vent[p - 1] / 5 != n) {
                for (int s = 0; s < 5; ++s) {
                    na += ivar[5 * n + s] == va;
                    nb += ivar[5 * n + s] == vb;
                }
            }
        }
        const int c = na * nb;
        int incl = c;
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += v;
        }
        if (out != nullptr && c > 0) {
            int k = total + incl - c;
            for (int si = 0; si < 5; ++si) {
                if (ivar[5 * n + si] != va) continue;
                for (int sj = 0; sj < 5; ++sj) {
                    if (ivar[5 * n + sj] != vb) continue;
                    const int code = n * 25 + si * 5 + sj;
                    out[k] = code;
                    epos[code] = k0 + k;
                    ++k;
                }
            }
        }
        total += __shfl_sync(FULL, incl, 31);
    }
    return total;
}

// CTA 0 the lists; CTAs 1.. the observations' chart rotations, ROT_Q a
// CTA (float64 trigonometry: one SM's rate would bound it)
constexpr int ROT_Q = 128;

__global__ void __launch_bounds__(PLAN_THREADS)
sg_plan_kernel(const __grid_constant__ PlanArgs a) {
    const Dims& d = a.d;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (blockIdx.x > 0) {
        const int q = (blockIdx.x - 1) * ROT_Q + tid;
        if (tid < ROT_Q && q < d.Q) {
            normal_rotation(a.ob_coeffs + 4 * q, a.rot + 9 * q);
        }
        return;
    }
    extern __shared__ int sm[];
    const int NI = d.NI(), V = d.V(), NS = 4 * d.Q + 8 * d.R + 2 * d.Dn;
    int* ivar = sm;                 // (NI, 5) slot variables, -1 past ns
    int* vent = ivar + 5 * NI;      // (NS,) each variable's entries n*5+s
    int* vptr = vent + NS;          // (V + 1,)
    int* wc = vptr + V + 1;         // (PLAN_WARPS, V) each warp's cursors
    int* sw = wc + PLAN_WARPS * V;  // scan scratch (PLAN_WARPS + 1)
    uint8_t* pm = reinterpret_cast<uint8_t*>(sw + PLAN_WARPS + 1);  // (V, V)

    // 1. live items in item order, and their slots' variables
    const int n_live = block_compact(
        NI, sw, [&](int i) { return item_live(a, i); },
        [&](int pos, int i) {
            a.live[pos] = i;
            const int ns = type_slots(item_type(i, d.Q, d.R));
            for (int s = 0; s < 5; ++s) {
                ivar[5 * pos + s] = s < ns ? slot_var(a, i, s) : -1;
            }
        });
    for (int n = n_live + tid; n < NI; n += PLAN_THREADS) a.live[n] = -1;
    for (int k = tid; k < PLAN_WARPS * V; k += PLAN_THREADS) wc[k] = 0;
    for (int k = tid; k < V * V; k += PLAN_THREADS) pm[k] = 0;
    __syncthreads();

    // 2. each variable's entries n*5+s in order: each warp counts its
    // contiguous range of entries by variable, the counts are turned into
    // each warp's first position for each variable, and each warp lists
    // its range (match_any ranks the entries of one variable in a warp)
    const int NE = 5 * n_live;
    const int span = (NE + 32 * PLAN_WARPS - 1) / (32 * PLAN_WARPS) * 32;
    const int lo = warp * span, hi = min(NE, lo + span);
    int* my_wc = wc + warp * V;
    for (int b = lo; b < hi; b += 32) {
        const int v = b + lane < hi ? ivar[b + lane] : -1;
        const unsigned peers = __match_any_sync(FULL, v);
        if (v >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
            my_wc[v] += __popc(peers);
        }
        __syncwarp();
    }
    __syncthreads();
    {
        int run = 0;
        for (int base = 0; base < V; base += PLAN_THREADS) {
            const int v = base + tid;
            int c = 0;
            if (v < V) {
                for (int w = 0; w < PLAN_WARPS; ++w) {
                    const int x = wc[w * V + v];
                    wc[w * V + v] = c;
                    c += x;
                }
            }
            int total;
            const int pos = run + block_scan(c, sw, total);
            if (v < V) {
                vptr[v] = pos;
                for (int w = 0; w < PLAN_WARPS; ++w) wc[w * V + v] += pos;
            }
            run += total;
        }
        if (tid == 0) vptr[V] = run;
    }
    __syncthreads();
    for (int b = lo; b < hi; b += 32) {
        const int v = b + lane < hi ? ivar[b + lane] : -1;
        const unsigned peers = __match_any_sync(FULL, v);
        const unsigned before = peers & ((1u << lane) - 1u);
        const int at = v >= 0 ? my_wc[v] : 0;
        __syncwarp();
        if (v >= 0) {
            vent[at + __popc(before)] = b + lane;
            if (before == 0) my_wc[v] = at + __popc(peers);
        }
        __syncwarp();
    }

    // 3. the coupled pairs: marked, then (a <= b) listed in index order
    for (int n = tid; n < n_live; n += PLAN_THREADS) {
        const int* iv = ivar + 5 * n;
        for (int si = 0; si < 5; ++si) {
            for (int sj = 0; sj < 5; ++sj) {
                if (iv[si] >= 0 && iv[sj] >= 0) pm[iv[si] * V + iv[sj]] = 1;
            }
        }
    }
    __syncthreads();
    const int n_pairs = block_compact(
        V * V, sw, [&](int k) { return pm[k] && k / V <= k % V; },
        [&](int pos, int k) { a.pairs[pos] = k; });
    for (int m = n_pairs + tid; m < a.np_cap; m += PLAN_THREADS) {
        a.pairs[m] = -1;
    }
    for (int k = tid; k < V * V; k += PLAN_THREADS) a.pmap[k] = pm[k];
    __syncthreads();

    // 4. each pair's contributors: counted (a warp a pair), offsets, then
    // listed in (n, si, sj) order
    for (int m = warp; m < n_pairs; m += PLAN_WARPS) {
        const int key = a.pairs[m];
        const int cnt = walk_pair(vptr, vent, ivar, key / V, key % V,
                                  nullptr, 0, nullptr);
        if (lane == 0) a.pptr[m] = cnt;
    }
    __syncthreads();
    int n_ent = 0;
    for (int base = 0; base < n_pairs; base += PLAN_THREADS) {
        const int m = base + tid;
        const int cnt = m < n_pairs ? a.pptr[m] : 0;
        int total;
        const int pos = n_ent + block_scan(cnt, sw, total);
        if (m < n_pairs) a.pptr[m] = pos;
        n_ent += total;
    }
    for (int m = n_pairs + tid; m <= a.np_cap; m += PLAN_THREADS) {
        a.pptr[m] = n_ent;
    }
    for (int k = n_ent + tid; k < a.ne_cap; k += PLAN_THREADS) {
        a.pent[k] = -1;
    }
    for (int k = tid; k < 25 * NI; k += PLAN_THREADS) a.epos[k] = -1;
    __syncthreads();
    for (int m = warp; m < n_pairs; m += PLAN_WARPS) {
        const int key = a.pairs[m], k0 = a.pptr[m];
        walk_pair(vptr, vent, ivar, key / V, key % V, a.pent + k0, k0,
                  a.epos);
    }
    if (tid == 0) {
        a.meta[0] = n_live;
        a.meta[1] = n_pairs;
    }
}

// ---------------------------------------------------------------- system

struct SysArgs {
    const float *poses, *planes, *rooms, *doors;
    Dims d;
    const int* ob_idx;
    const float *ob_coeffs, *ob_info, *ob_quadric, *quad_info;
    const int* room_idx;
    const float* room_info;
    const int* door_idx;
    const float *door_rel, *door_info;
    float huber[5];
    const int *live, *pairs, *pptr, *pent, *epos;
    const uint8_t* pmap;
    const double* rot;
    const int* meta;
    double *M, *G;  // (ne_cap, BS), (ne_cap, GB) the contributors' blocks
    const float *S_kf, *rhs_kf;
    float *S, *rhs;
};

// Grid-wide barrier (every CTA resident: a cooperative launch) in two
// levels, so that arrivals contend on a group's counter and the groups'
// (a single counter serialises every CTA's atomic).  The last arrival of
// the last group releases the others by the generation word; the counters
// return to zero after the release, for the next launch.
__device__ void grid_sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned n_groups = (gridDim.x + BAR_GROUP - 1) / BAR_GROUP;
        const unsigned g = blockIdx.x / BAR_GROUP;
        const unsigned in_group =
            min((unsigned)BAR_GROUP, gridDim.x - g * BAR_GROUP);
        unsigned* top = &g_sg_bar[BAR_MAX_GROUPS];
        volatile unsigned* gen = &g_sg_bar[BAR_MAX_GROUPS + 1];
        const unsigned g0 = *gen;
        __threadfence();
        bool released = false;
        if (atomicAdd(&g_sg_bar[g], 1u) == in_group - 1) {
            if (atomicAdd(top, 1u) == n_groups - 1) {
                atomicAdd(&g_sg_bar[BAR_MAX_GROUPS + 1], 1u);
                *top = 0u;
                released = true;
            }
            g_sg_bar[g] = 0u;
        }
        if (!released) {
            while (*gen == g0) __nanosleep(32);
        }
        __threadfence();
    }
    __syncthreads();
}

// the values staged in a CTA's shared memory
struct Stage {
    const double* rot;  // (P, 9) chart rotation of each plane
    const double* pv0;  // (P, 4) each plane's oplus at delta = 0
    const float *poses, *planes, *rooms, *doors;
};

__device__ __forceinline__ DualD s_abs(DualD x) {
    return x.v > 0.0 ? x : (x.v < 0.0 ? -x : mkdd(0.0, 0.0));
}

// coeffs / max(|n|, tiny): the quotients and their derivatives by one
// reciprocal (a float64 division is a long dependent chain)
__device__ void plane_normalize(const DualD* v, DualD* out) {
    DualD n = s_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    if (n.v < 2.2250738585072014e-308) n = mkdd(2.2250738585072014e-308);
    const double r = 1.0 / n.v;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const double q = v[i].v * r;
        out[i] = mkdd(q, (v[i].d - q * n.d) * r);
    }
}

// plane oplus of the constant plane c (chart rotation R) by dl at the
// linearisation point: dl's values are 0, whose cosine and sine are 1 and 0
// (s_cos / s_sin without the calls)
__device__ void plane_oplus(const float* c, const double* R, const DualD* dl,
                            DualD* out) {
    const DualD ce = mkdd(1.0, -0.0 * dl[1].d), se = mkdd(0.0, dl[1].d);
    const DualD nl[3] = {ce * mkdd(1.0, -0.0 * dl[0].d),
                         ce * mkdd(0.0, dl[0].d), se};
    DualD v[4];
    for (int i = 0; i < 3; ++i) {
        v[i] = R[3 * i] * nl[0] + R[3 * i + 1] * nl[1] + R[3 * i + 2] * nl[2];
    }
    v[3] = -((-(double)c[3]) + dl[2]);
    plane_normalize(v, out);
}

// plane transform by an SE(3) [q, t]: n' = R n, c' = c - t . n'
__device__ void plane_transform(const DualD* T, const DualD* c, DualD* out) {
    DualD v[4];
    quat_rot(T, c, v);
    v[3] = c[3] - (T[4] * v[0] + T[5] * v[1] + T[6] * v[2]);
    plane_normalize(v, out);
}

// chart coordinates of ``other`` relative to the constant plane ``ref``
// (chart rotation R)
__device__ void plane_ominus(const float* ref, const double* R,
                             const DualD* other, DualD* out) {
    DualD n[3];
    for (int i = 0; i < 3; ++i) {
        n[i] = R[i] * other[0] + R[3 + i] * other[1] + R[6 + i] * other[2];
    }
    out[0] = s_atan2(n[1], n[0]);
    out[1] = s_atan2(n[2], s_sqrt(n[0] * n[0] + n[1] * n[1]));
    out[2] = (-other[3]) - (-(double)ref[3]);
}

// exp(d) . T0 (lie.se3_boxplus) of a constant pose
__device__ void se3_retract(const float* T0, const DualD* d, DualD* out) {
    DualD E[7], P[7];
    for (int k = 0; k < 7; ++k) P[k] = mkdd(T0[k]);
    se3_exp(d, E);
    se3_mul(E, P, out);
}

// mid-surface anchor of a facing wall pair (factors.py::_room_pair_vec)
__device__ void room_pair_vec(const DualD* a, const DualD* b, DualD* out) {
    DualD w1[4], w2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        w1[i] = a[3].v > 0.0f ? -a[i] : a[i];
        w2[i] = b[3].v > 0.0f ? -b[i] : b[i];
    }
    // element-wise selections (a selected array would live in local
    // memory)
    const bool first = s_abs(w1[3]).v > s_abs(w2[3]).v;
    const DualD db = s_abs(first ? w1[3] : w2[3]);
    const DualD ds = s_abs(first ? w2[3] : w1[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const DualD big = first ? w1[i] : w2[i];
        const DualD small = first ? w2[i] : w1[i];
        out[i] = 0.5f * (db * big - ds * small) + ds * small;
    }
}

// Live item n's whitened residual in dual numbers seeded on its tangent
// direction ``lane`` (none past its directions): values into rv, column
// ``lane`` of the whitened Jacobian into Jc.
__device__ void lane_linearize(const SysArgs& a, const Stage& st, int t,
                               int k, int lane, double* rv, double* Jc) {
    const int nd = type_dirs(t);
    // the seeded slot and component
    int my_slot = -1, my_comp = 0;
    if (lane < nd) {
        if (t == 2 || t == 3) {
            my_slot = lane / 3;
            my_comp = lane % 3;
        } else {
            my_slot = lane < 6 ? 0 : 1;
            my_comp = lane < 6 ? lane : lane - 6;
        }
    }
    auto seed = [&](int s, int c) {
        return mkdd(0.0, (s == my_slot && c == my_comp) ? 1.0 : 0.0);
    };
    DualD r[3];
    float info;
    if (t <= 1) {
        DualD dk[6], dp[3], T[7], pw[4], pl[4];
        for (int c = 0; c < 6; ++c) dk[c] = seed(0, c);
        for (int c = 0; c < 3; ++c) dp[c] = seed(1, c);
        const int kf = a.ob_idx[2 * k], p = a.ob_idx[2 * k + 1];
        se3_retract(st.poses + 7 * kf, dk, T);
        plane_oplus(st.planes + 4 * p, st.rot + 9 * p, dp, pw);
        plane_transform(T, pw, pl);
        if (t == 0) {
            plane_ominus(a.ob_coeffs + 4 * k, a.rot + 9 * k, pl, r);
            info = a.ob_info[k];
        } else {
            const float* G = a.ob_quadric + 16 * k;
            DualD e = mkdd(0.0);
            for (int j = 0; j < 4; ++j) {
                DualD v = mkdd(0.0);
                for (int i = 0; i < 4; ++i) {
                    v = v + pl[i] * (double)G[4 * i + j];
                }
                e = e + v * pl[j];
            }
            if (!(e.v >= 1e-12)) e = mkdd(1e-12);  // clamp(e, min=1e-12)
            r[0] = s_sqrt(e);
            info = a.quad_info[k];
        }
    } else if (t <= 3) {
        const int ns = type_slots(t);
        DualD c[3], w[4][4], mine[4], dl[3];
        const float* c0 = st.rooms + 3 * a.room_idx[5 * k];
        for (int j = 0; j < 3; ++j) c[j] = (double)c0[j] + seed(0, j);
        // only the lane's own wall (wall 1, unseeded, on the room's lanes)
        // has a derivative: one oplus in dual numbers, the other walls'
        // values (and every wall's value) from the staged oplus at 0
        const int ws = my_slot >= 1 ? my_slot : 1;
        const int pw = a.room_idx[5 * k + ws];
        for (int j = 0; j < 3; ++j) dl[j] = seed(ws, j);
        plane_oplus(st.planes + 4 * pw, st.rot + 9 * pw, dl, mine);
#pragma unroll
        for (int s = 1; s < 5; ++s) {
            if (s >= ns) break;
            const double* v0 = st.pv0 + 4 * a.room_idx[5 * k + s];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                w[s - 1][i] = mkdd(v0[i], s == ws ? mine[i].d : 0.0);
            }
        }
        DualD v1[3], v2[3];
        room_pair_vec(w[0], w[1], v1);
        if (t == 2) {
            room_pair_vec(w[2], w[3], v2);
            for (int j = 0; j < 3; ++j) r[j] = c[j] - (v1[j] + v2[j]);
        } else {
            for (int j = 0; j < 3; ++j) r[j] = c[j] - v1[j];
        }
        info = a.room_info[k];
    } else {
        DualD dd[6], T[7];
        for (int j = 0; j < 6; ++j) dd[j] = seed(0, j);
        se3_retract(st.doors + 7 * a.door_idx[2 * k], dd, T);
        const float* c0 = st.rooms + 3 * a.door_idx[2 * k + 1];
        const float* rel = a.door_rel + 3 * k;
        for (int j = 0; j < 3; ++j) {
            r[j] = (T[4 + j] - ((double)c0[j] + seed(1, j))) -
                   (double)rel[j];
        }
        info = a.door_info[k];
    }
    const int nr = type_rows(t);
    const double sq = sqrt((double)info);
    for (int j = 0; j < 3; ++j) {
        rv[j] = j < nr ? r[j].v * sq : 0.0;
        Jc[j] = j < nr ? r[j].d * sq : 0.0;
    }
}

// valid * min(1, huber / sqrt(max(chi2, 1e-12))) of whitened residuals
__device__ double huber_weight(const double* rv, int nr, float huber) {
    double chi2 = 0.0;
    for (int k = 0; k < nr; ++k) chi2 += rv[k] * rv[k];
    return fmin(huber / sqrt(fmax(chi2, 1e-12)), 1.0);
}

// the variable of slot s of item (t, k)
__device__ int item_var(const SysArgs& a, int t, int k, int s) {
    const Dims& d = a.d;
    if (t <= 1) return s == 0 ? a.ob_idx[2 * k] : d.L + a.ob_idx[2 * k + 1];
    if (t <= 3) {
        return s == 0 ? d.L + d.P + a.room_idx[5 * k]
                      : d.L + a.room_idx[5 * k + s];
    }
    return s == 0 ? d.L + d.P + d.R + a.door_idx[2 * k]
                  : d.L + d.P + a.door_idx[2 * k + 1];
}

// A warp: live item n's blocks of w J^T J (and, on a diagonal pair, of
// w J^T r) at their contributor positions; ``Jw`` the warp's (3, 32)
// shared staging of the Jacobian's columns
__device__ void linearize_item(const SysArgs& a, const Stage& st, int n,
                               int lane, double* Jw) {
    const int i = a.live[n];
    const int t = item_type(i, a.d.Q, a.d.R), k = i - type_base(t, a.d.Q,
                                                                a.d.R);
    const int nd = type_dirs(t), nr = type_rows(t), ns = type_slots(t);
    // the lane's slot and its variable, every slot's variable, and the
    // positions of the lane's blocks with the slots on a variable >= its
    // own (constant indices: the arrays stay in registers)
    int si = 0, vs[5], kpos[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        vs[s] = s < ns ? item_var(a, t, k, s) : -1;
        if (s < ns && lane >= slot_dir(t, s)) si = s;
    }
    int vsi = vs[0];
#pragma unroll
    for (int s = 1; s < 5; ++s) vsi = si == s ? vs[s] : vsi;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        const int e = __ldg(a.epos + 25 * n + 5 * si + s);
        kpos[s] = s < ns && lane < nd && vsi <= vs[s] ? e : -1;
    }
    double rv[3], Jc[3];
    lane_linearize(a, st, t, k, lane, rv, Jc);
    const double w = huber_weight(rv, nr, a.huber[t]);
    const int ca = lane - slot_dir(t, si);
    if (lane < nd) {
        double gs = 0.0;
        for (int j = 0; j < nr; ++j) gs += Jc[j] * rv[j];
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            if (kpos[s] >= 0 && vs[s] == vsi) {
                a.G[(size_t)kpos[s] * GB + ca] = s == si ? w * gs : 0.0;
            }
        }
    }
    // row ``lane`` of w J^T J over the Jacobian staged in shared memory
#pragma unroll
    for (int j = 0; j < 3; ++j) Jw[32 * j + lane] = Jc[j];
    __syncwarp();
    int sj = 0, kp = kpos[0];
    for (int b = 0; b < nd; ++b) {
        if (sj + 1 < ns && b == slot_dir(t, sj + 1)) {
            ++sj;
#pragma unroll
            for (int s = 1; s < 5; ++s) kp = sj == s ? kpos[s] : kp;
        }
        double h = 0.0;
        for (int j = 0; j < nr; ++j) h += Jc[j] * Jw[32 * j + b];
        if (kp >= 0) {
            const int wb = (t == 2 || t == 3 || sj == 1) ? 3 : 6;
            a.M[(size_t)kp * BS + ca * wb + b - slot_dir(t, sj)] = w * h;
        }
    }
}

// A warp: the block of the coupled pair ``key`` (and its transpose) from
// its contributors k0 .. k1 - 1, and with the diagonal pair the
// variable's rhs entries
__device__ void pair_sums(const SysArgs& a, int key, int k0, int k1,
                          int lane) {
    const Dims& d = a.d;
    const int V = d.V(), D = d.D(), kd = 6 * d.L;
    const int va = key / V, vb = key % V;
    const int wa = d.width(va), wb = d.width(vb);
    const int r0 = d.col(va), c0 = d.col(vb);
    const bool diag = va == vb;
    const int nf = wa * wb;
    const int f0 = lane, f1 = lane + 32;
    const int a0 = f0 / wb, b0 = f0 % wb, a1 = f1 / wb, b1 = f1 % wb;
    const bool own0 = f0 < nf && (!diag || a0 <= b0);
    const bool own1 = f1 < nf && (!diag || a1 <= b1);
    const bool own_g = diag && lane < wa;
    double acc0 = 0.0, acc1 = 0.0, gacc = 0.0;
    const double* M = a.M + (size_t)k0 * BS;
    const double* G = a.G + (size_t)k0 * GB;
#pragma unroll 8
    for (int k = 0; k < k1 - k0; ++k) {
        if (own0) acc0 += M[(size_t)k * BS + f0];
        if (own1) acc1 += M[(size_t)k * BS + f1];
        if (own_g) gacc += G[(size_t)k * GB + lane];
    }
    auto put = [&](int ca, int cb, double acc) {
        const int r = r0 + ca, c = c0 + cb;
        const float v = (float)acc;
        const bool kf = va < d.L && vb < d.L;
        a.S[(size_t)r * D + c] = kf ? __fadd_rn(v, a.S_kf[r * kd + c]) : v;
        if (r != c) {
            a.S[(size_t)c * D + r] =
                kf ? __fadd_rn(v, a.S_kf[c * kd + r]) : v;
        }
    };
    if (own0) put(a0, b0, acc0);
    if (own1) put(a1, b1, acc1);
    if (own_g) {
        const int r = r0 + lane;
        const float v = -(float)gacc;
        a.rhs[r] = va < d.L ? __fadd_rn(v, a.rhs_kf[r]) : v;
    }
}

// at most 128 registers, so that 4 CTAs fit an SM: one warp for each of
// the main path's 2096 item slots
__global__ void __launch_bounds__(THREADS, 4)
sg_system_kernel(const __grid_constant__ SysArgs a) {
    extern __shared__ double sh[];
    const Dims& d = a.d;
    Stage st;
    double* rot = sh;
    double* pv0 = sh + 9 * d.P;
    float* poses = reinterpret_cast<float*>(sh + 13 * d.P);
    float* planes = poses + 7 * d.L;
    float* rooms = planes + 4 * d.P;
    float* doors = rooms + 3 * d.R;
    const int tid = threadIdx.x, lane = tid & 31;
    for (int k = tid; k < 7 * d.L; k += THREADS) poses[k] = a.poses[k];
    for (int k = tid; k < 4 * d.P; k += THREADS) planes[k] = a.planes[k];
    for (int k = tid; k < 3 * d.R; k += THREADS) rooms[k] = a.rooms[k];
    for (int k = tid; k < 7 * d.Dn; k += THREADS) doors[k] = a.doors[k];
    for (int p = tid; p < d.P; p += THREADS) {
        double* R = rot + 9 * p;
        normal_rotation(a.planes + 4 * p, R);
        // plane_oplus at delta = 0: the rotated +x axis and the distance
        double n = sqrt(R[0] * R[0] + R[3] * R[3] + R[6] * R[6]);
        if (n < 2.2250738585072014e-308) n = 2.2250738585072014e-308;
        const double q = 1.0 / n;
        pv0[4 * p] = R[0] * q;
        pv0[4 * p + 1] = R[3] * q;
        pv0[4 * p + 2] = R[6] * q;
        pv0[4 * p + 3] = (double)a.planes[4 * p + 3] * q;
    }
    st.rot = rot;
    st.pv0 = pv0;
    st.poses = poses;
    st.planes = planes;
    st.rooms = rooms;
    st.doors = doors;
    __syncthreads();
    const int gw = (blockIdx.x * THREADS + tid) >> 5;
    const int n_warps = gridDim.x * WARPS;
    const int n_live = a.meta[0];
    const size_t vals = sizeof(double) * 13 * d.P +
                        sizeof(float) * (7 * d.L + 4 * d.P + 3 * d.R +
                                         7 * d.Dn);
    double* Jw = sh + (vals + 7) / 8 + 96 * (tid >> 5);
    for (int n = gw; n < n_live; n += n_warps) {
        linearize_item(a, st, n, lane, Jw);
        __syncwarp();
    }

    // entries no item reaches: S_kf / rhs_kf, else 0 (the twin's H = 0,
    // rhs = -0); written by the CTAs without an item when there are such
    // (they would wait at the barrier), else by all
    const int V = d.V(), D = d.D(), kd = 6 * d.L;
    const long long DD = (long long)D * D;
    const int busy = n_live >= n_warps ? 0 : (n_live + WARPS - 1) / WARPS;
    const int f0 = busy < (int)gridDim.x ? busy : 0;
    const int fb = (int)blockIdx.x - f0;
    for (long long x = (long long)fb * THREADS + tid; fb >= 0 && x < DD + D;
         x += (long long)((int)gridDim.x - f0) * THREADS) {
        if (x < DD) {
            const int r = (int)(x / D), c = (int)(x % D);
            if (!a.pmap[d.var_of(r) * V + d.var_of(c)]) {
                a.S[x] = (r < kd && c < kd)
                             ? __fadd_rn(0.0f, a.S_kf[r * kd + c])
                             : 0.0f;
            }
        } else {
            const int r = (int)(x - DD), v = d.var_of(r);
            if (!a.pmap[v * V + v]) {
                a.rhs[r] = r < kd ? __fadd_rn(-0.0f, a.rhs_kf[r]) : -0.0f;
            }
        }
    }
    // the first coupled pair's position in the plan, read before the
    // barrier
    const int n_pairs = a.meta[1];
    int key = -1, k0 = 0, k1 = 0;
    if (gw < n_pairs) {
        key = a.pairs[gw];
        k0 = a.pptr[gw];
        k1 = a.pptr[gw + 1];
    }
    grid_sync();
    for (int m = gw; m < n_pairs; m += n_warps) {
        if (m != gw) {
            key = a.pairs[m];
            k0 = a.pptr[m];
            k1 = a.pptr[m + 1];
        }
        pair_sums(a, key, k0, k1, lane);
    }
}

}  // namespace

// Factor operands (SgFactors, fast_ba.py): ob_idx (Q, 2) i32 [local kf,
// plane], ob_coeffs (Q, 4) f32, ob_valid / quad_valid (Q,) u8, room_idx
// (R, 5) i32 [room, walls], room4_valid / room2_valid (R,) u8, door_idx
// (Dn, 2) i32 [door, room], door_valid (Dn,) u8; L keyframes, P planes.
// Writes the plan: live (NI,) i32 (NI = 2Q + 2R + Dn), pairs (np_cap,) i32
// a * V + b, pptr (np_cap + 1,) i32, pent (ne_cap,) i32 n * 25 + si * 5 +
// sj, pmap (V, V) u8, rot (Q, 9) f64, meta (2,) i32 [live items, pairs];
// past the counts live / pairs / pent hold -1 and pptr the total.  One
// launch: one CTA for the lists, one for each 128 observations' rotations.
VSG_API int vsg_sg_plan(const int* ob_idx, const float* ob_coeffs,
                        const uint8_t* ob_valid, const uint8_t* quad_valid,
                        int Q, const int* room_idx,
                        const uint8_t* room4_valid,
                        const uint8_t* room2_valid, int R,
                        const int* door_idx, const uint8_t* door_valid,
                        int Dn, int L, int P, int np_cap, int ne_cap,
                        int* live, int* pairs, int* pptr, int* pent,
                        int* epos, uint8_t* pmap, double* rot, int* meta,
                        cudaStream_t stream) {
    PlanArgs a;
    a.ob_idx = ob_idx;
    a.ob_coeffs = ob_coeffs;
    a.ob_valid = ob_valid;
    a.quad_valid = quad_valid;
    a.room_idx = room_idx;
    a.room4_valid = room4_valid;
    a.room2_valid = room2_valid;
    a.door_idx = door_idx;
    a.door_valid = door_valid;
    a.d = Dims{L, P, R, Dn, Q};
    a.np_cap = np_cap;
    a.ne_cap = ne_cap;
    a.live = live;
    a.pairs = pairs;
    a.pptr = pptr;
    a.pent = pent;
    a.epos = epos;
    a.pmap = pmap;
    a.rot = rot;
    a.meta = meta;
    const long long NI = 2LL * Q + 2LL * R + Dn, V = (long long)L + P + R + Dn;
    const long long NS = 4LL * Q + 8LL * R + 2LL * Dn;
    const long long smem =
        4 * (5 * NI + NS + V + 1 + PLAN_WARPS * V + PLAN_WARPS + 1) + V * V;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        sg_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = 1 + (Q + ROT_Q - 1) / ROT_Q;
    sg_plan_kernel<<<grid, PLAN_THREADS, (size_t)smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Values: poses (L, 7), planes (P, 4), rooms (R, 3), doors (Dn, 7) f32;
// the factor operands as vsg_sg_plan's with ob_info (Q,), ob_quadric
// (Q, 4, 4), quad_info (Q,), room_info (R,), door_rel (Dn, 3), door_info
// (Dn,) f32; huber_*: the five types' widths; the plan's arrays and its
// scratch M (NI, 225) / G (NI, 15) f64; S_kf (6L, 6L), rhs_kf (6L,) f32.
// Writes every entry of S (D, D) and rhs (D,) f32, D = 6L + 3P + 3R + 6Dn:
// S = H + [S_kf 0; 0 0], rhs = [rhs_kf 0] - g.  One cooperative launch.
VSG_API int vsg_sg_system(
    const float* poses, int L, const float* planes, int P, const float* rooms,
    int R, const float* doors, int Dn, const int* ob_idx,
    const float* ob_coeffs, const float* ob_info, const float* ob_quadric,
    const float* quad_info, int Q, const int* room_idx,
    const float* room_info, const int* door_idx, const float* door_rel,
    const float* door_info, float huber_kf, float huber_quad,
    float huber_room4, float huber_room2, float huber_door, const int* live,
    const int* pairs, const int* pptr, const int* pent, const int* epos,
    const uint8_t* pmap, const double* rot, const int* meta, double* M,
    double* G,
    const float* S_kf, const float* rhs_kf, float* S, float* rhs,
    cudaStream_t stream) {
    SysArgs a;
    a.poses = poses;
    a.planes = planes;
    a.rooms = rooms;
    a.doors = doors;
    a.d = Dims{L, P, R, Dn, Q};
    a.ob_idx = ob_idx;
    a.ob_coeffs = ob_coeffs;
    a.ob_info = ob_info;
    a.ob_quadric = ob_quadric;
    a.quad_info = quad_info;
    a.room_idx = room_idx;
    a.room_info = room_info;
    a.door_idx = door_idx;
    a.door_rel = door_rel;
    a.door_info = door_info;
    a.huber[0] = huber_kf;
    a.huber[1] = huber_quad;
    a.huber[2] = huber_room4;
    a.huber[3] = huber_room2;
    a.huber[4] = huber_door;
    a.live = live;
    a.pairs = pairs;
    a.pptr = pptr;
    a.pent = pent;
    a.epos = epos;
    a.pmap = pmap;
    a.rot = rot;
    a.meta = meta;
    a.M = M;
    a.G = G;
    a.S_kf = S_kf;
    a.rhs_kf = rhs_kf;
    a.S = S;
    a.rhs = rhs;
    // the staged values, then each warp's Jacobian (8-byte aligned)
    const size_t vals = sizeof(double) * 13 * P +
                        sizeof(float) * (7 * L + 4 * P + 3 * R + 7 * Dn);
    const size_t smem = (vals + 7) / 8 * 8 + sizeof(double) * 96 * WARPS;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    // resident CTAs of this shared size (queried once per size)
    static size_t queried = (size_t)-1;
    static int resident = 0;
    cudaError_t err;
    if (queried != smem) {
        err = cudaFuncSetAttribute(
            sg_system_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        int occ = 0, dev = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, sg_system_kernel, THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        if (occ < 1) return (int)cudaErrorInvalidConfiguration;
        resident = occ * sms < BAR_GROUP * BAR_MAX_GROUPS
                       ? occ * sms : BAR_GROUP * BAR_MAX_GROUPS;
        queried = smem;
    }
    // a warp a live item at most (the plan's pairs are fewer than its
    // items' slot pairs, and the fill strides)
    const long long NI = 2LL * Q + 2LL * R + Dn;
    const long long need = (NI + WARPS - 1) / WARPS;
    const int grid = (int)(need < 1 ? 1 : need < resident ? need : resident);
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((void*)sg_system_kernel, dim3(grid),
                                      dim3(THREADS), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
