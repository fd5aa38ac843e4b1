// K21: linearisation and dense normal-equation assembly of the scene-graph
// factors of the keyframe path's local BA.
//
// Replaces visual_sgraphs_tpu/optim/fast_ba.py:46::_assemble_dense over
// optim/graph.py:154::linearize_batch, as fast_scenegraph_ba (:197) runs it
// every iteration: per item of five factor types (optim/factors.py:112,
// 128, 161, 172, 181) the whitened residual, its Jacobians by jax.jacfwd
// through each family's retraction at delta = 0 (se3_boxplus for keyframe
// and door poses, plane oplus for planes, + for room centres), the weight
// valid * min(1, huber / sqrt(max(chi2, 1e-12))), and the scatter of
// w J_i^T J_j and w J_i^T r into a dense (D, D) system over
// [kf (L, 6) | plane (P, 3) | room (R, 3) | door (Dn, 6)].
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
// and writes the 646 KB of H once; each item is a few hundred flops per
// tangent direction, ~3 MFLOP in all.
//
// Design: one launch covers all five types, one warp per item, the warps
// split by type in the order above.  Lane l evaluates the residual in dual
// numbers seeded on the item's tangent direction l (9 or 15 directions),
// through the same branches as the twin (lie.cuh's exp / multiply, the
// plane chart, |.| and the sign / magnitude selections of
// _room_pair_vec, the clamp under plane_quadric's sqrt): each is a choice
// on the value that takes the derivative of the chosen branch, which is
// what forward-mode AD computes.  Lane a then holds column a of the
// whitened Jacobian, gathers the others by shuffles and adds row a of
// w J^T J and entry a of w J^T r with float32 atomics.  All of it is
// float64 (lie.cuh's DualD) up to those float32 adds.  Over all direction
// pairs this adds the block of slots (i, j) at (c_i, c_j) and its
// transpose at (c_j, c_i) for i != j, so two slots on one variable (two
// walls of a room on one plane) add twice, as the twin's scatter does.
// Invalid items (weight 0, including those whose -1 indices were clamped)
// are skipped: they add zeros to the twin's system.  Atomics sum in a
// changing order: H and g are held against the float64 twin at 1e-4 of
// their largest entries.  Why float64: the Gij-quadric residual
// sqrt(pi^T G pi) cancels (G's entries are ~|p|^2, tens, while pi^T G pi
// is a mean squared distance, ~1e-4), so float32 loses ~3 digits there
// (the float32 twin's H is ~1e-3 off the float64 one).
#include "lie.cuh"

namespace {

__device__ __forceinline__ DualD s_abs(DualD x) {
    return x.v > 0.0 ? x : (x.v < 0.0 ? -x : mkdd(0.0, 0.0));
}

// Rz(azimuth) Ry(-elevation) of a constant normal, row-major
// (core/plane.py::normal_rotation)
__device__ void normal_rotation(const float* vf, double* R) {
    const double v[3] = {vf[0], vf[1], vf[2]};
    const double az = atan2(v[1], v[0]);
    const double el = atan2(v[2], sqrt(v[0] * v[0] + v[1] * v[1]));
    const double ca = cos(az), sa = sin(az), ce = cos(el), se = sin(el);
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

// coeffs / max(|n|, tiny)
__device__ void plane_normalize(const DualD* v, DualD* out) {
    DualD n = s_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    if (n.v < 2.2250738585072014e-308) n = mkdd(2.2250738585072014e-308);
    for (int i = 0; i < 4; ++i) out[i] = v[i] / n;
}

// plane oplus of the constant plane c by the chart perturbation dl
__device__ void plane_oplus(const float* c, const DualD* dl, DualD* out) {
    double R[9];
    normal_rotation(c, R);
    const DualD ce = s_cos(dl[1]), se = s_sin(dl[1]);
    const DualD nl[3] = {ce * s_cos(dl[0]), ce * s_sin(dl[0]), se};
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
__device__ void plane_ominus(const float* ref, const DualD* other, DualD* out) {
    double R[9];
    normal_rotation(ref, R);
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
    for (int i = 0; i < 4; ++i) {
        w1[i] = a[3].v > 0.0f ? -a[i] : a[i];
        w2[i] = b[3].v > 0.0f ? -b[i] : b[i];
    }
    const bool first = s_abs(w1[3]).v > s_abs(w2[3]).v;
    const DualD* big = first ? w1 : w2;
    const DualD* small = first ? w2 : w1;
    const DualD db = s_abs(big[3]), ds = s_abs(small[3]);
    for (int i = 0; i < 3; ++i) {
        out[i] = 0.5f * (db * big[i] - ds * small[i]) + ds * small[i];
    }
}

struct SgArgs {
    const float *poses, *planes, *rooms, *doors;
    int L, P, R, Dn, Q, D;
    const int* ob_idx;
    const float *ob_coeffs, *ob_info;
    const uint8_t* ob_valid;
    const float *ob_quadric, *quad_info;
    const uint8_t* quad_valid;
    const int* room_idx;
    const float* room_info;
    const uint8_t *room4_valid, *room2_valid;
    const int* door_idx;
    const float *door_rel, *door_info;
    const uint8_t* door_valid;
    float huber[5];
};

constexpr int kMaxSlots = 5;

// One factor item: its type, the first column and width of each of its
// variable slots in H, its validity and information.
struct Item {
    int type, item, ns, nr;
    int col0[kMaxSlots], width[kMaxSlots];
    bool ok;
    float info;
};

// The item that warp ``warp`` takes (types in the order of the table
// above); false past the last item.
__device__ bool item_of(const SgArgs& a, int warp, Item& it) {
    int item = warp;
    if (item < a.Q) {
        it.type = 0;
    } else if ((item -= a.Q) < a.Q) {
        it.type = 1;
    } else if ((item -= a.Q) < a.R) {
        it.type = 2;
    } else if ((item -= a.R) < a.R) {
        it.type = 3;
    } else if ((item -= a.R) < a.Dn) {
        it.type = 4;
    } else {
        return false;
    }
    it.item = item;
    const int off_pl = 6 * a.L, off_rm = off_pl + 3 * a.P;
    const int off_dr = off_rm + 3 * a.R;
    it.nr = 3;
    if (it.type <= 1) {
        it.ok = it.type == 0 ? a.ob_valid[item] : a.quad_valid[item];
        it.info = it.type == 0 ? a.ob_info[item] : a.quad_info[item];
        it.nr = it.type == 0 ? 3 : 1;
        it.ns = 2;
        it.col0[0] = 6 * a.ob_idx[2 * item];
        it.width[0] = 6;
        it.col0[1] = off_pl + 3 * a.ob_idx[2 * item + 1];
        it.width[1] = 3;
    } else if (it.type <= 3) {
        it.ok = it.type == 2 ? a.room4_valid[item] : a.room2_valid[item];
        it.info = a.room_info[item];
        it.ns = it.type == 2 ? 5 : 3;
        it.col0[0] = off_rm + 3 * a.room_idx[5 * item];
        it.width[0] = 3;
        for (int s = 1; s < it.ns; ++s) {
            it.col0[s] = off_pl + 3 * a.room_idx[5 * item + s];
            it.width[s] = 3;
        }
    } else {
        it.ok = a.door_valid[item];
        it.info = a.door_info[item];
        it.ns = 2;
        it.col0[0] = off_dr + 6 * a.door_idx[2 * item];
        it.width[0] = 6;
        it.col0[1] = off_rm + 3 * a.door_idx[2 * item + 1];
        it.width[1] = 3;
    }
    return true;
}

// The item's residual in dual numbers seeded on tangent direction
// ``lane`` (none past the item's directions): whitened values into rv,
// the whitened Jacobian's column ``lane`` into Jc, and the H row of that
// direction into *row (-1 past the item's directions).  Returns the
// item's number of directions.
__device__ int lane_linearize(const SgArgs& a, const Item& it, int lane,
                              double* rv, double* Jc, int* row) {
    int ndir = 0, my_slot = -1, my_comp = 0;
    for (int s = 0; s < it.ns; ++s) {
        if (lane >= ndir && lane < ndir + it.width[s]) {
            my_slot = s;
            my_comp = lane - ndir;
        }
        ndir += it.width[s];
    }
    *row = my_slot >= 0 ? it.col0[my_slot] + my_comp : -1;
    auto seed = [&](int s, int c) {
        return mkdd(0.0, (s == my_slot && c == my_comp) ? 1.0 : 0.0);
    };
    const int item = it.item;
    DualD r[3];
    if (it.type <= 1) {
        DualD dk[6], dp[3], T[7], pw[4], pl[4];
        for (int c = 0; c < 6; ++c) dk[c] = seed(0, c);
        for (int c = 0; c < 3; ++c) dp[c] = seed(1, c);
        se3_retract(a.poses + 7 * a.ob_idx[2 * item], dk, T);
        plane_oplus(a.planes + 4 * a.ob_idx[2 * item + 1], dp, pw);
        plane_transform(T, pw, pl);
        if (it.type == 0) {
            plane_ominus(a.ob_coeffs + 4 * item, pl, r);
        } else {
            const float* G = a.ob_quadric + 16 * item;
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
        }
    } else if (it.type <= 3) {
        DualD c[3], w[4][4];
        const float* c0 = a.rooms + 3 * a.room_idx[5 * item];
        for (int k = 0; k < 3; ++k) c[k] = (double)c0[k] + seed(0, k);
        for (int s = 1; s < it.ns; ++s) {
            DualD d[3];
            for (int k = 0; k < 3; ++k) d[k] = seed(s, k);
            plane_oplus(a.planes + 4 * a.room_idx[5 * item + s], d,
                        w[s - 1]);
        }
        DualD v1[3], v2[3];
        room_pair_vec(w[0], w[1], v1);
        if (it.type == 2) {
            room_pair_vec(w[2], w[3], v2);
            for (int k = 0; k < 3; ++k) r[k] = c[k] - (v1[k] + v2[k]);
        } else {
            for (int k = 0; k < 3; ++k) r[k] = c[k] - v1[k];
        }
    } else {
        DualD dd[6], T[7];
        for (int k = 0; k < 6; ++k) dd[k] = seed(0, k);
        se3_retract(a.doors + 7 * a.door_idx[2 * item], dd, T);
        const float* c0 = a.rooms + 3 * a.door_idx[2 * item + 1];
        const float* rel = a.door_rel + 3 * item;
        for (int k = 0; k < 3; ++k) {
            r[k] = (T[4 + k] - ((double)c0[k] + seed(1, k))) -
                   (double)rel[k];
        }
    }
    const double sq = sqrt((double)it.info);
    for (int k = 0; k < 3; ++k) {
        rv[k] = k < it.nr ? r[k].v * sq : 0.0;
        Jc[k] = k < it.nr ? r[k].d * sq : 0.0;
    }
    return ndir;
}

// valid * min(1, huber / sqrt(max(chi2, 1e-12))) of whitened residuals
__device__ double huber_weight(const double* rv, int nr, float huber) {
    double chi2 = 0.0;
    for (int k = 0; k < nr; ++k) chi2 += rv[k] * rv[k];
    return fmin(huber / sqrt(fmax(chi2, 1e-12)), 1.0);
}

__global__ void sg_assemble_kernel(SgArgs a, float* __restrict__ H,
                                   float* __restrict__ g) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    Item it;
    // whole warps leave together
    if (!item_of(a, warp, it) || !it.ok) return;
    double rv[3], Jc[3];
    int row;
    const int ndir = lane_linearize(a, it, lane, rv, Jc, &row);
    const double w = huber_weight(rv, it.nr, a.huber[it.type]);
    const bool mine = row >= 0;
    double gs = 0.0;
    for (int k = 0; k < it.nr; ++k) gs += Jc[k] * rv[k];
    if (mine && gs != 0.0) atomicAdd(&g[row], (float)(w * gs));
    // row ``lane`` of w J^T J: column b of J comes from lane b
    int s = 0, base = 0;
    for (int b = 0; b < ndir; ++b) {
        if (b == base + it.width[s]) {
            base += it.width[s];
            ++s;
        }
        double h = 0.0;
        for (int k = 0; k < it.nr; ++k) {
            h += Jc[k] * __shfl_sync(0xffffffffu, Jc[k], b);
        }
        if (mine && h != 0.0) {
            atomicAdd(&H[(size_t)row * a.D + it.col0[s] + (b - base)],
                      (float)(w * h));
        }
    }
}

}  // namespace

// Values: poses (L, 7), planes (P, 4), rooms (R, 3), doors (Dn, 7) f32.
// Plane observations (Q items): ob_idx (Q, 2) i32 [local kf, plane],
// ob_coeffs (Q, 4), ob_info (Q,), ob_valid (Q,) u8 (plane-KF), ob_quadric
// (Q, 4, 4), quad_info (Q,), quad_valid (Q,) u8 (Gij quadric).  Rooms:
// room_idx (R, 5) i32 [room, walls], room_info (R,), room4_valid /
// room2_valid (R,) u8.  Doors: door_idx (Dn, 2) i32 [door, room], door_rel
// (Dn, 3), door_info (Dn,), door_valid (Dn,) u8.  huber_*: the five types'
// widths.  H (D, D) and g (D,) f32 zero-filled by the caller, D = 6L + 3P
// + 3R + 6Dn: H += sum w J^T J, g += sum w J^T r.
VSG_API int vsg_sg_assemble(
    const float* poses, int L, const float* planes, int P, const float* rooms,
    int R, const float* doors, int Dn, const int* ob_idx,
    const float* ob_coeffs, const float* ob_info, const uint8_t* ob_valid,
    const float* ob_quadric, const float* quad_info,
    const uint8_t* quad_valid, int Q, const int* room_idx,
    const float* room_info, const uint8_t* room4_valid,
    const uint8_t* room2_valid, const int* door_idx, const float* door_rel,
    const float* door_info, const uint8_t* door_valid, float huber_kf,
    float huber_quad, float huber_room4, float huber_room2,
    float huber_door, float* H, float* g, cudaStream_t stream) {
    SgArgs a;
    a.poses = poses;
    a.planes = planes;
    a.rooms = rooms;
    a.doors = doors;
    a.L = L;
    a.P = P;
    a.R = R;
    a.Dn = Dn;
    a.Q = Q;
    a.D = 6 * L + 3 * P + 3 * R + 6 * Dn;
    a.ob_idx = ob_idx;
    a.ob_coeffs = ob_coeffs;
    a.ob_info = ob_info;
    a.ob_valid = ob_valid;
    a.ob_quadric = ob_quadric;
    a.quad_info = quad_info;
    a.quad_valid = quad_valid;
    a.room_idx = room_idx;
    a.room_info = room_info;
    a.room4_valid = room4_valid;
    a.room2_valid = room2_valid;
    a.door_idx = door_idx;
    a.door_rel = door_rel;
    a.door_info = door_info;
    a.door_valid = door_valid;
    a.huber[0] = huber_kf;
    a.huber[1] = huber_quad;
    a.huber[2] = huber_room4;
    a.huber[3] = huber_room2;
    a.huber[4] = huber_door;
    const long long warps = 2LL * Q + 2LL * R + Dn;
    if (warps == 0) return 0;
    const int threads = 128;
    const long long blocks = (warps * 32 + threads - 1) / threads;
    sg_assemble_kernel<<<(unsigned)blocks, threads, 0, stream>>>(a, H, g);
    return (int)cudaGetLastError();
}
