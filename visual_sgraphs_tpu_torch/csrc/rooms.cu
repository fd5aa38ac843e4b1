// K23: the room pair analysis of the scene graph, wall-based (rooms_walls)
// and seeded by free-space clusters (rooms_freespace).
//
// rooms_walls replaces visual_sgraphs_tpu/scenegraph/manager.py:310::
// detect_rooms: ``rounds`` greedy rounds over the facing wall pairs i < j
// of the plane table (normals anti-parallel, gap and lateral offset in
// range).  A round takes the pair of largest support (npts_i + npts_j),
// then among the facing pairs whose first wall is perpendicular to it the
// one whose centre lies nearest; two pairs make a room, one a corridor.
// The candidate gets its ground plane and is upserted into the room table,
// and its walls are consumed for the next round.
// rooms_freespace replaces visual_sgraphs_tpu/scenegraph/freespace.py:122::
// detect_rooms_freespace: one round per free-space cluster centre (K17b's
// output, read on the device), where only walls near the centre compete,
// without the lateral test, the second pair is the one nearest the centre,
// and no wall is consumed.
//
// What bounds it here: latency.  It reads ~3 KB of plane and room tables
// and writes ~0.7 KB; at P = 64 the pair geometry is ~2016 pairs x ~40
// flops and each round ~4096 x 12, a few hundred kFLOP.  The reference's
// rounds are ~60 dependent small array operations each.  Design: one block
// of 512 threads, one launch a call.  The tables sit in shared memory;
// the round-independent pair geometry is one flag byte a pair, computed
// once; a round is two block-wide arg-max passes over the P^2 row-major
// flattened pairs (``vsg_block_arg_best``: the first extreme, as
// jnp.argmax, so ties go to the lowest flat index i P + j, and an all
// -inf / all -1 score selects index 0) and one upsert, whose ground and
// room-match selections are block-wide too and whose writes thread 0 makes.
// The pair centres, the room centre and the distances that the arg-max
// compares are correctly rounded operations in the plain version's order,
// so the centres are bitwise equal and ties stay ties.  A corridor's walls
// (i1, j1, -1, -1) consume walls (i1, j1, 0, 0) in sequence with the last
// write winning, as the reference's scatter: a corridor on wall 0 leaves
// wall 0 free.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxP = 128;
constexpr int kMaxR = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kGround = 0, kWall = 1;

struct RoomsSmem {
    float n[kMaxP][3], d[kMaxP], cen[kMaxP][3], npts[kMaxP];
    uint8_t is_ground[kMaxP], is_wall[kMaxP], free_wall[kMaxP],
        perp[kMaxP];
    uint8_t geo[kMaxP * kMaxP];  // pair geometry passes, i < j
    float r_center[kMaxR][3];
    int r_walls[kMaxR][4], r_ground[kMaxR];
    uint8_t r_corr[kMaxR], r_valid[kMaxR], r_cand[kMaxR];
    int n_rooms;
    float red_v[kWarps];
    int red_i[kWarps];
};

__device__ __forceinline__ float dot3_rn(const float* a, const float* b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                     __fmul_rn(a[2], b[2]));
}

// |a - b|, the sum of squares in order, as torch.linalg.norm over 3
__device__ __forceinline__ float dist3_rn(const float* a, const float* b) {
    const float x = __fsub_rn(a[0], b[0]), y = __fsub_rn(a[1], b[1]),
                z = __fsub_rn(a[2], b[2]);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z)));
}

// 0.5 (c_i + c_j), component k
__device__ __forceinline__ float half_sum(float a, float b) {
    return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// Load the plane table and its classes (plane_semantics: the first
// maximum of the votes, UNDEFINED below min_votes or for invalid planes)
// and the room table.
__device__ void load_tables(RoomsSmem& s, int P, int R,
                            const float* __restrict__ coeffs,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ centroid,
                            const float* __restrict__ npts,
                            const float* __restrict__ votes, float min_votes,
                            const float* __restrict__ r_center,
                            const int* __restrict__ r_walls,
                            const uint8_t* __restrict__ r_corr,
                            const uint8_t* __restrict__ r_valid,
                            const int* __restrict__ r_ground,
                            const int* __restrict__ n_rooms) {
    const int tid = threadIdx.x;
    for (int p = tid; p < P; p += kThreads) {
        for (int k = 0; k < 3; ++k) {
            s.n[p][k] = coeffs[4 * p + k];
            s.cen[p][k] = centroid[3 * p + k];
        }
        s.d[p] = coeffs[4 * p + 3];
        s.npts[p] = npts[p];
        const float* v = votes + 3 * p;
        int best = 0;
        float strength = v[0];
        bool nan = isnan(v[0]);
        for (int c = 1; c < 3; ++c) {
            nan = nan || isnan(v[c]);
            if (v[c] > strength) {
                strength = v[c];
                best = c;
            }
        }
        const bool ok = valid[p] && !nan && strength >= min_votes;
        s.is_ground[p] = ok && best == kGround;
        s.is_wall[p] = ok && best == kWall;
        s.free_wall[p] = s.is_wall[p];
    }
    for (int r = tid; r < R; r += kThreads) {
        for (int k = 0; k < 3; ++k) s.r_center[r][k] = r_center[3 * r + k];
        for (int k = 0; k < 4; ++k) s.r_walls[r][k] = r_walls[4 * r + k];
        s.r_corr[r] = r_corr[r];
        s.r_valid[r] = r_valid[r];
        s.r_ground[r] = r_ground[r];
    }
    if (tid == 0) s.n_rooms = *n_rooms;
}

// The round-independent pair geometry: n_i . n_j < -0.9, min_gap < gap <
// max_gap along n_i and, with ``lateral``, the centroid offset across n_i
// below max_gap; i < j.
__device__ void pair_geometry(RoomsSmem& s, int P, float min_gap,
                              float max_gap, bool lateral) {
    for (int q = threadIdx.x; q < P * P; q += kThreads) {
        const int i = q / P, j = q % P;
        bool ok = i < j && dot3_rn(s.n[i], s.n[j]) < -0.9f;
        if (ok) {
            const float c[3] = {__fsub_rn(s.cen[j][0], s.cen[i][0]),
                                __fsub_rn(s.cen[j][1], s.cen[i][1]),
                                __fsub_rn(s.cen[j][2], s.cen[i][2])};
            const float t = dot3_rn(s.n[i], c);
            const float gap = fabsf(t);
            ok = gap > min_gap && gap < max_gap;
            if (ok && lateral) {
                float l2 = 0.0f;
                for (int k = 0; k < 3; ++k) {
                    const float r = __fsub_rn(c[k], __fmul_rn(t, s.n[i][k]));
                    const float r2 = __fmul_rn(r, r);
                    l2 = k == 0 ? r2 : __fadd_rn(l2, r2);
                }
                ok = __fsqrt_rn(l2) < max_gap;
            }
        }
        s.geo[q] = ok;
    }
}

// The facing pair of largest support among walls flagged in ``wall``
// (b1), then, among the facing pairs whose first wall is perpendicular to
// b1's first wall, the one whose centre is nearest ``to`` (or, when ``to``
// is null, nearest b1's centre) (b2).  Writes the candidate: found (b1
// exists), its centre, walls and corridor flag (b2 does not exist).
__device__ void select_candidate(RoomsSmem& s, int P, const uint8_t* wall,
                                 float perp_tol, const float* to,
                                 bool& found, float center[3], int walls[4],
                                 bool& corridor) {
    const int tid = threadIdx.x;
    float v = -INFINITY;
    int b = INT_MAX;
    for (int q = tid; q < P * P; q += kThreads) {
        const int i = q / P, j = q % P;
        const float sup = s.geo[q] && wall[i] && wall[j]
                              ? __fadd_rn(s.npts[i], s.npts[j])
                              : -1.0f;
        if (vsg_better<true>(sup, q, v, b)) {
            v = sup;
            b = q;
        }
    }
    vsg_block_arg_best<true>(v, b, s.red_v, s.red_i);
    const int i1 = b / P, j1 = b % P;
    const bool have1 = v > 0.0f;
    float c1[3];
    for (int k = 0; k < 3; ++k) c1[k] = half_sum(s.cen[i1][k], s.cen[j1][k]);
    for (int p = tid; p < P; p += kThreads) {
        s.perp[p] = fabsf(dot3_rn(s.n[p], s.n[i1])) < perp_tol;
    }
    __syncthreads();
    const float* ref = to != nullptr ? to : c1;
    float v2 = -INFINITY;
    int b2 = INT_MAX;
    for (int q = tid; q < P * P; q += kThreads) {
        const int i = q / P, j = q % P;
        float sc = -INFINITY;
        if (s.geo[q] && wall[i] && wall[j] && s.perp[i]) {
            float pc[3];
            for (int k = 0; k < 3; ++k) {
                pc[k] = half_sum(s.cen[i][k], s.cen[j][k]);
            }
            sc = -dist3_rn(pc, ref);
        }
        if (vsg_better<true>(sc, q, v2, b2)) {
            v2 = sc;
            b2 = q;
        }
    }
    vsg_block_arg_best<true>(v2, b2, s.red_v, s.red_i);
    const int i2 = b2 / P, j2 = b2 % P;
    const bool have2 = isfinite(v2);
    const bool room = have1 && have2;
    corridor = have1 && !have2;
    found = room || corridor;
    for (int k = 0; k < 3; ++k) {
        const float c2 = half_sum(s.cen[i2][k], s.cen[j2][k]);
        center[k] = room ? half_sum(c1[k], c2) : c1[k];
    }
    walls[0] = i1;
    walls[1] = j1;
    walls[2] = room ? i2 : -1;
    walls[3] = room ? j2 : -1;
}

// Write a candidate into the room table (manager.py::upsert_room): its
// ground is the first arg-max of npts over the ground planes within
// max_gap of its centre; it updates the valid room that lies within 1.5 m
// or shares >= 2 walls (-1 walls never count), the nearest first, else
// takes slot min(n_rooms, R - 1) while n_rooms < R.  All threads call it.
__device__ void upsert_room(RoomsSmem& s, int P, int R, bool found,
                            const float center[3], const int walls[4],
                            bool corridor, float max_gap) {
    const int tid = threadIdx.x;
    float gv = -INFINITY;
    int gi = INT_MAX;
    bool any_ok = false;
    for (int p = tid; p < P; p += kThreads) {
        const bool ok =
            s.is_ground[p] && dist3_rn(s.cen[p], center) < max_gap;
        any_ok = any_ok || ok;
        const float val = ok ? s.npts[p] : -1.0f;
        if (vsg_better<true>(val, p, gv, gi)) {
            gv = val;
            gi = p;
        }
    }
    const bool any_ground = __syncthreads_or(any_ok);
    vsg_block_arg_best<true>(gv, gi, s.red_v, s.red_i);
    float rv = INFINITY;
    int ri = INT_MAX;
    for (int r = tid; r < R; r += kThreads) {
        int shared = 0;
        for (int a = 0; a < 4; ++a) {
            const int w = s.r_walls[r][a];
            for (int b = 0; b < 4; ++b) shared += w >= 0 && w == walls[b];
        }
        const float cd = dist3_rn(s.r_center[r], center);
        const bool cand = s.r_valid[r] && (cd < 1.5f || shared >= 2);
        s.r_cand[r] = cand;
        const float val = cand ? cd : INFINITY;
        if (vsg_better<false>(val, r, rv, ri)) {
            rv = val;
            ri = r;
        }
    }
    vsg_block_arg_best<false>(rv, ri, s.red_v, s.red_i);
    if (tid == 0) {
        const bool matched = found && s.r_cand[ri];
        const int n = s.n_rooms;
        const int slot = matched ? ri : min(n, R - 1);
        if (found && (matched || n < R)) {
            for (int k = 0; k < 3; ++k) s.r_center[slot][k] = center[k];
            for (int k = 0; k < 4; ++k) s.r_walls[slot][k] = walls[k];
            s.r_corr[slot] = corridor;
            s.r_ground[slot] = any_ground ? gi : -1;
            s.r_valid[slot] = 1;
            if (!matched) s.n_rooms = n + 1;
        }
    }
    __syncthreads();
}

__device__ void store_rooms(const RoomsSmem& s, int R, float* r_center,
                            int* r_walls, uint8_t* r_corr, uint8_t* r_valid,
                            int* r_ground, int* n_rooms) {
    for (int r = threadIdx.x; r < R; r += kThreads) {
        for (int k = 0; k < 3; ++k) r_center[3 * r + k] = s.r_center[r][k];
        for (int k = 0; k < 4; ++k) r_walls[4 * r + k] = s.r_walls[r][k];
        r_corr[r] = s.r_corr[r];
        r_valid[r] = s.r_valid[r];
        r_ground[r] = s.r_ground[r];
    }
    if (threadIdx.x == 0) *n_rooms = s.n_rooms;
}

struct RoomTables {
    const float* center;
    const int* walls;
    const uint8_t* corr;
    const uint8_t* valid;
    const int* ground;
    const int* n;
    float* center_out;
    int* walls_out;
    uint8_t* corr_out;
    uint8_t* valid_out;
    int* ground_out;
    int* n_out;
};

struct PlaneTable {
    const float* coeffs;
    const uint8_t* valid;
    const float* centroid;
    const float* npts;
    const float* votes;
};

__global__ void __launch_bounds__(kThreads)
rooms_walls_kernel(PlaneTable pl, int P, RoomTables rt, int R,
                   float min_votes, float min_gap, float max_gap,
                   float perp_tol, int rounds) {
    __shared__ RoomsSmem s;
    load_tables(s, P, R, pl.coeffs, pl.valid, pl.centroid, pl.npts, pl.votes,
                min_votes, rt.center, rt.walls, rt.corr, rt.valid, rt.ground,
                rt.n);
    __syncthreads();
    pair_geometry(s, P, min_gap, max_gap, true);
    __syncthreads();
    for (int round = 0; round < rounds; ++round) {
        bool found, corridor;
        float center[3];
        int walls[4];
        select_candidate(s, P, s.free_wall, perp_tol, nullptr, found, center,
                         walls, corridor);
        upsert_room(s, P, R, found, center, walls, corridor, max_gap);
        if (threadIdx.x == 0 && found) {
            // the reference's scatter: used[clip(w)] = w >= 0 in order,
            // the last write winning, then free &= ~used
            bool used[4];
            for (int a = 0; a < 4; ++a) {
                const int wa = min(max(walls[a], 0), P - 1);
                bool u = walls[a] >= 0;
                for (int b = a + 1; b < 4; ++b) {
                    if (min(max(walls[b], 0), P - 1) == wa) u = walls[b] >= 0;
                }
                used[a] = u;
            }
            for (int a = 0; a < 4; ++a) {
                if (used[a]) s.free_wall[min(max(walls[a], 0), P - 1)] = 0;
            }
        }
        __syncthreads();
    }
    store_rooms(s, R, rt.center_out, rt.walls_out, rt.corr_out, rt.valid_out,
                rt.ground_out, rt.n_out);
}

__global__ void __launch_bounds__(kThreads)
rooms_freespace_kernel(PlaneTable pl, int P, RoomTables rt, int R,
                       const float* __restrict__ centers,
                       const uint8_t* __restrict__ centers_valid, int C,
                       float min_votes, float wall_dist, float min_gap,
                       float max_gap, float perp_tol) {
    __shared__ RoomsSmem s;
    __shared__ uint8_t near_wall[kMaxP];
    load_tables(s, P, R, pl.coeffs, pl.valid, pl.centroid, pl.npts, pl.votes,
                min_votes, rt.center, rt.walls, rt.corr, rt.valid, rt.ground,
                rt.n);
    __syncthreads();
    pair_geometry(s, P, min_gap, max_gap, false);
    const float lat_max = 2.0f * wall_dist;
    for (int c = 0; c < C; ++c) {
        const float ctr[3] = {centers[3 * c], centers[3 * c + 1],
                              centers[3 * c + 2]};
        const bool ok_c = centers_valid[c];
        for (int p = threadIdx.x; p < P; p += kThreads) {
            const float plane_d =
                fabsf(__fadd_rn(dot3_rn(s.n[p], ctr), s.d[p]));
            near_wall[p] = ok_c && s.is_wall[p] && plane_d < wall_dist
                           && dist3_rn(s.cen[p], ctr) < lat_max;
        }
        __syncthreads();
        bool found, corridor;
        float center[3];
        int walls[4];
        select_candidate(s, P, near_wall, perp_tol, ctr, found, center, walls,
                         corridor);
        upsert_room(s, P, R, found, center, walls, corridor, max_gap);
    }
    store_rooms(s, R, rt.center_out, rt.walls_out, rt.corr_out, rt.valid_out,
                rt.ground_out, rt.n_out);
}

}  // namespace

// Plane table: coeffs (P, 4), valid (P,) bool, centroid (P, 3), npts (P,),
// votes (P, 3), all f32 but valid; P <= 128.  Room table in: center
// (R, 3) f32, walls (R, 4) i32, is_corridor / valid (R,) bool, ground (R,)
// i32, n_rooms () i32; R <= 64; the same fields out (separate buffers).
VSG_API int vsg_rooms_walls(const float* coeffs, const uint8_t* valid,
                            const float* centroid, const float* npts,
                            const float* votes, int P, const float* r_center,
                            const int* r_walls, const uint8_t* r_corr,
                            const uint8_t* r_valid, const int* r_ground,
                            const int* n_rooms, int R, float min_votes,
                            float min_gap, float max_gap, float perp_tol,
                            int rounds, float* center_out, int* walls_out,
                            uint8_t* corr_out, uint8_t* valid_out,
                            int* ground_out, int* n_out,
                            cudaStream_t stream) {
    if (P < 1 || P > kMaxP || R < 1 || R > kMaxR || rounds < 0) {
        return (int)cudaErrorInvalidValue;
    }
    rooms_walls_kernel<<<1, kThreads, 0, stream>>>(
        PlaneTable{coeffs, valid, centroid, npts, votes}, P,
        RoomTables{r_center, r_walls, r_corr, r_valid, r_ground, n_rooms,
                   center_out, walls_out, corr_out, valid_out, ground_out,
                   n_out},
        R, min_votes, min_gap, max_gap, perp_tol, rounds);
    return (int)cudaGetLastError();
}

// As vsg_rooms_walls, with C cluster centres (C, 3) f32 and their
// validity (C,) bool on the device.
VSG_API int vsg_rooms_freespace(const float* coeffs, const uint8_t* valid,
                                const float* centroid, const float* npts,
                                const float* votes, int P,
                                const float* r_center, const int* r_walls,
                                const uint8_t* r_corr, const uint8_t* r_valid,
                                const int* r_ground, const int* n_rooms,
                                int R, const float* centers,
                                const uint8_t* centers_valid, int C,
                                float min_votes, float wall_dist,
                                float min_gap, float max_gap, float perp_tol,
                                float* center_out, int* walls_out,
                                uint8_t* corr_out, uint8_t* valid_out,
                                int* ground_out, int* n_out,
                                cudaStream_t stream) {
    if (P < 1 || P > kMaxP || R < 1 || R > kMaxR || C < 0) {
        return (int)cudaErrorInvalidValue;
    }
    rooms_freespace_kernel<<<1, kThreads, 0, stream>>>(
        PlaneTable{coeffs, valid, centroid, npts, votes}, P,
        RoomTables{r_center, r_walls, r_corr, r_valid, r_ground, n_rooms,
                   center_out, walls_out, corr_out, valid_out, ground_out,
                   n_out},
        R, centers, centers_valid, C, min_votes, wall_dist, min_gap, max_gap,
        perp_tol);
    return (int)cudaGetLastError();
}
