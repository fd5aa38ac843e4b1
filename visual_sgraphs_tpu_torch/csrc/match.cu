// K5: window-restricted Hamming matcher with best-2, ratio test and
// duplicate-target resolution.
//
// Replaces visual_sgraphs_tpu/features/match.py::match_window (with its
// ::hamming_matrix building block).  The JAX version unpacks descriptors
// to 256 floats and runs an all-pairs matmul on the TPU's matrix unit,
// then masks and top-2s the full (Na, Nb) matrix.
//
// What bounds it here: integer ALU work, Na*Nb*8 XOR+popcount pairs
// (4096 x 1000 on the tracking path), with each query's window test in
// front.  Device memory is tiny (Nb descriptors, 32 KB).
//
// Design: one thread per query row; the block stages tiles of the target
// set (descriptors as 8 x uint32, pixels, validity, levels) in shared
// memory and every thread scans them with a fused window/level mask and a
// running best-2 that keeps the lower index on ties (lax.top_k's order).
// No (Na, Nb) matrix exists.  The ratio/max-distance gate follows, and
// duplicate targets are resolved with atomicMin into a (Nb,) claim buffer
// plus a second tiny pass that keeps best <= claimed[nn].  The window test
// uses __fmul_rn/__fadd_rn so it rounds exactly like the plain PyTorch
// version; outputs are integers and agree exactly.
#include "common.cuh"

namespace {

constexpr int TILE = 128;
constexpr int BIG = 10000;

__global__ void match_pass1(const uint32_t* __restrict__ desc_a,
                            const float* __restrict__ uv_a,
                            const uint8_t* __restrict__ valid_a,
                            const int* __restrict__ level_a,
                            const uint32_t* __restrict__ desc_b,
                            const float* __restrict__ uv_b,
                            const uint8_t* __restrict__ valid_b,
                            const int* __restrict__ level_b,
                            int n_a, int n_b, float r2, int level_slack,
                            float ratio, int max_dist,
                            int* __restrict__ match, int* __restrict__ dist,
                            int* __restrict__ claimed) {
    __shared__ uint32_t s_desc[TILE][8];
    __shared__ float s_u[TILE];
    __shared__ float s_v[TILE];
    __shared__ uint8_t s_valid[TILE];
    __shared__ int s_level[TILE];

    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = a < n_a;
    uint32_t da[8];
    float ua = 0.0f, va = 0.0f;
    bool oka = false;
    int la = 0;
    if (active) {
#pragma unroll
        for (int k = 0; k < 8; ++k) da[k] = desc_a[8 * a + k];
        ua = uv_a[2 * a];
        va = uv_a[2 * a + 1];
        oka = valid_a[a] != 0;
        la = level_a != nullptr ? level_a[a] : 0;
    }
    int best = 0x7fffffff;
    int second = 0x7fffffff;
    int best_i = 0;
    for (int t0 = 0; t0 < n_b; t0 += TILE) {
        __syncthreads();
        for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
            const int b = t0 + i;
            if (b < n_b) {
#pragma unroll
                for (int k = 0; k < 8; ++k) s_desc[i][k] = desc_b[8 * b + k];
                s_u[i] = uv_b[2 * b];
                s_v[i] = uv_b[2 * b + 1];
                s_valid[i] = valid_b[b];
                s_level[i] = level_b != nullptr ? level_b[b] : 0;
            }
        }
        __syncthreads();
        if (!active) continue;
        const int n_t = min(TILE, n_b - t0);
        for (int i = 0; i < n_t; ++i) {
            bool m = oka && s_valid[i] != 0;
            if (m) {
                const float du = __fsub_rn(ua, s_u[i]);
                const float dv = __fsub_rn(va, s_v[i]);
                m = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2;
                if (m && level_a != nullptr) {
                    m = abs(la - s_level[i]) <= level_slack;
                }
            }
            int d = BIG;
            if (m) {
                d = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) d += __popc(da[k] ^ s_desc[i][k]);
            }
            if (d < best) {
                second = best;
                best = d;
                best_i = t0 + i;
            } else if (d < second) {
                second = d;
            }
        }
    }
    if (!active) return;
    const bool ok = best <= max_dist &&
                    (float)best <= __fmul_rn(ratio, (float)second);
    match[a] = ok ? best_i : -1;
    dist[a] = best;
    if (ok) atomicMin(&claimed[best_i], best);
}

__global__ void match_pass2(int n_a, const int* __restrict__ claimed,
                            int* __restrict__ match, int* __restrict__ dist) {
    const int a = blockIdx.x * blockDim.x + threadIdx.x;
    if (a >= n_a) return;
    int nn = match[a];
    if (nn >= 0 && dist[a] > claimed[nn]) nn = -1;
    match[a] = nn;
    if (nn < 0) dist[a] = BIG;
}

// ---- NN ratio (SearchByBoW) -------------------------------------------
//
// Replaces features/match.py::match_nn_ratio with ::_rotation_consistency
// (loop verification and relocalisation: 1000 x 1000 keyframe
// descriptors).  The JAX version top-2s the full (Na, Nb) Hamming matrix,
// argmins its transpose for the mutual check and scatters a 30-bin
// histogram.  Bound: integer operations (Na*Nb XOR+popcount pairs, twice:
// once by rows, once by columns); at 1000 x 1000 that is ~2 us of
// popcounts spread over the card, so what matters is using every SM and
// keeping each round of global loads in flight together.
//
// Design: one launch.  A CTA takes 16 queries (8 warps, two queries a
// warp, their descriptors in registers): the first ceil(n_a / 16) CTAs
// take rows of a against b, the next ceil(n_b / 16) (with the mutual
// check) columns of b against a, so 1000 x 1000 runs on 126 CTAs, one
// wave.  Each CTA stages the other side's descriptors in shared memory
// in tiles of 1024 (9 words a target, so that a warp's 32 lanes reading
// word k of 32 consecutive targets hit 32 banks) and a warp's lanes
// stride the targets, each target read once for both queries.  A lane
// keeps a running best-2 (rows: best, its column, second; the lower
// column wins ties, an equal later distance goes to second) or first
// best row (columns); a shuffle tree merges the lanes with the same rule
// (best of the union by (distance, index), second = min(winner's second,
// loser's best)), exact on integers, so every lane ends equal.  The last
// CTA to take a self-resetting ticket finishes: the ratio and max_dist
// gates, the mutual check, the 30-bin rotation histogram in shared-memory
// integer atomics (exact, order-free) with the twin's fmodf / floorf
// rounding, the third-largest count by three rounds of a warp arg-max,
// and the outputs.  Integers throughout: exact.  The ticket is one global
// counter: launches of this kernel must not overlap (one stream).
constexpr float TWO_PI_F = 6.28318548202514648f;  // float32(2 pi)
constexpr int HISTO = 30;
constexpr int NN_THREADS = 256;
constexpr int NN_WARPS = NN_THREADS / 32;
constexpr int NN_QPW = 2;  // queries a warp
constexpr int NN_QPC = NN_WARPS * NN_QPW;  // queries a CTA
constexpr int NN_TILE = 1024;  // targets staged a pass
constexpr int NN_STRIDE = 9;  // words a staged target (8 + 1 pad)
constexpr int NN_STAGE = 2 * NN_TILE / NN_THREADS;  // 16-byte loads a thread
constexpr int NN_ROWS = 4;  // the finish's rows a thread a round
// the finish's (ok << 7 | bin) a row, in the staging buffer
constexpr int NN_MAX_A = NN_TILE * NN_STRIDE * 4;

__device__ unsigned g_nn_ticket;

struct NNArgs {
    const uint32_t* desc_a;  // (n_a, 8)
    const uint8_t* valid_a;
    const uint32_t* desc_b;  // (n_b, 8)
    const uint8_t* valid_b;
    const float* angle_a;  // (n_a,) or null
    const float* angle_b;  // (n_b,) or null
    int n_a, n_b, row_ctas, mutual, max_dist;
    float ratio;
    int* nn;  // scratch (n_a,): each row's best column
    int* best;  // (n_a,)
    int* second;  // (n_a,)
    int* back;  // (n_b,): each column's first best row
    int* match;  // (n_a,) out
    int* dist;  // (n_a,) out
};

__global__ void __launch_bounds__(NN_THREADS)
nn_ratio_kernel(const __grid_constant__ NNArgs a) {
    __shared__ uint32_t s_t[NN_TILE * NN_STRIDE];
    __shared__ uint8_t s_tv[NN_TILE];
    __shared__ int s_counts[HISTO];
    __shared__ int s_thresh;
    __shared__ bool s_last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool rows = (int)blockIdx.x < a.row_ctas;
    // rows: queries of a, targets of b; columns: queries of b, targets of a
    const uint32_t* qd = rows ? a.desc_a : a.desc_b;
    const uint8_t* qv = rows ? a.valid_a : a.valid_b;
    const uint32_t* td = rows ? a.desc_b : a.desc_a;
    const uint8_t* tv = rows ? a.valid_b : a.valid_a;
    const int n_q = rows ? a.n_a : a.n_b;
    const int n_t = rows ? a.n_b : a.n_a;
    const int q0 = ((rows ? blockIdx.x : blockIdx.x - a.row_ctas) * NN_QPC)
                   + warp * NN_QPW;
    uint32_t dq[NN_QPW][8];
    bool okq[NN_QPW];
#pragma unroll
    for (int j = 0; j < NN_QPW; ++j) {
        const int q = q0 + j;
        okq[j] = q < n_q && qv[q] != 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) dq[j][k] = q < n_q ? qd[8 * q + k] : 0u;
    }
    // a lane's running best (distance, index) and, for rows, second
    int b1[NN_QPW], i1[NN_QPW], b2[NN_QPW];
#pragma unroll
    for (int j = 0; j < NN_QPW; ++j) {
        b1[j] = 0x7fffffff;
        i1[j] = 0x7fffffff;
        b2[j] = 0x7fffffff;
    }
    const uint4* td4 = reinterpret_cast<const uint4*>(td);
    for (int t0 = 0; t0 < n_t; t0 += NN_TILE) {
        const int cnt = min(NN_TILE, n_t - t0);
        __syncthreads();
        // every load of the tile in flight before the first store
        uint4 v[NN_STAGE];
        uint8_t f[NN_STAGE / 2];
#pragma unroll
        for (int u = 0; u < NN_STAGE; ++u) {
            const int i = u * NN_THREADS + tid;
            if (i < 2 * cnt) v[u] = td4[2 * t0 + i];
            if (u < NN_STAGE / 2 && i < cnt) f[u] = tv[t0 + i];
        }
#pragma unroll
        for (int u = 0; u < NN_STAGE; ++u) {
            const int i = u * NN_THREADS + tid;
            if (i < 2 * cnt) {
                uint32_t* dst = s_t + (i >> 1) * NN_STRIDE + 4 * (i & 1);
                dst[0] = v[u].x;
                dst[1] = v[u].y;
                dst[2] = v[u].z;
                dst[3] = v[u].w;
            }
            if (u < NN_STAGE / 2 && i < cnt) s_tv[i] = f[u];
        }
        __syncthreads();
        for (int t = lane; t < cnt; t += 32) {
            const uint32_t* w = s_t + t * NN_STRIDE;
            uint32_t x[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) x[k] = w[k];
            const bool vt = s_tv[t] != 0;
#pragma unroll
            for (int j = 0; j < NN_QPW; ++j) {
                int d = BIG;
                if (okq[j] && vt) {
                    d = 0;
#pragma unroll
                    for (int k = 0; k < 8; ++k) d += __popc(dq[j][k] ^ x[k]);
                }
                if (d < b1[j]) {
                    b2[j] = b1[j];
                    b1[j] = d;
                    i1[j] = t0 + t;
                } else if (d < b2[j]) {
                    b2[j] = d;
                }
            }
        }
    }
    // merge the lanes: best of the union by (distance, index); the
    // second is the least of the winner's second and the loser's best
#pragma unroll
    for (int j = 0; j < NN_QPW; ++j) {
        for (int off = 16; off > 0; off >>= 1) {
            const int ob = __shfl_xor_sync(0xffffffffu, b1[j], off);
            const int oi = __shfl_xor_sync(0xffffffffu, i1[j], off);
            const int os = __shfl_xor_sync(0xffffffffu, b2[j], off);
            if (ob < b1[j] || (ob == b1[j] && oi < i1[j])) {
                b2[j] = min(os, b1[j]);
                b1[j] = ob;
                i1[j] = oi;
            } else {
                b2[j] = min(b2[j], ob);
            }
        }
        const int q = q0 + j;
        if (lane == 0 && q < n_q) {
            if (rows) {
                a.nn[q] = i1[j];
                a.best[q] = b1[j];
                a.second[q] = b2[j];
            } else {
                a.back[q] = i1[j];
            }
            __threadfence();
        }
    }
    // ---- the last CTA to finish applies the gates and the histogram
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        s_last = atomicInc(&g_nn_ticket, gridDim.x - 1) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const bool angles = a.angle_a != nullptr;
    uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_t);
    if (tid < HISTO) s_counts[tid] = 0;
    __syncthreads();
    // NN_ROWS rows a thread a round, each round's loads issued together
    for (int base = 0; base < a.n_a; base += NN_ROWS * NN_THREADS) {
        int j[NN_ROWS], bq[NN_ROWS], sq[NN_ROWS], bk[NN_ROWS];
        uint8_t va[NN_ROWS];
        float da[NN_ROWS];
#pragma unroll
        for (int u = 0; u < NN_ROWS; ++u) {
            const int q = base + u * NN_THREADS + tid;
            const bool in = q < a.n_a;
            j[u] = in ? __ldcg(a.nn + q) : 0;
            bq[u] = in ? __ldcg(a.best + q) : BIG;
            sq[u] = in ? __ldcg(a.second + q) : BIG;
            va[u] = in ? a.valid_a[q] : 0;
        }
#pragma unroll
        for (int u = 0; u < NN_ROWS; ++u) {
            const int q = base + u * NN_THREADS + tid;
            bk[u] = a.mutual && q < a.n_a ? __ldcg(a.back + j[u]) : q;
            da[u] = angles && q < a.n_a
                        ? __fsub_rn(a.angle_a[q], a.angle_b[j[u]]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < NN_ROWS; ++u) {
            const int q = base + u * NN_THREADS + tid;
            if (q >= a.n_a) continue;
            const bool ok =
                bq[u] <= a.max_dist &&
                (float)bq[u] <= __fmul_rn(a.ratio, (float)sq[u]) &&
                va[u] != 0 && bk[u] == q;
            int bin = 0;
            if (angles) {
                float m = fmodf(da[u], TWO_PI_F);
                if (m != 0.0f && m < 0.0f) m = __fadd_rn(m, TWO_PI_F);
                bin = ((int)floorf(__fmul_rn(__fdiv_rn(m, TWO_PI_F),
                                             (float)HISTO))) % HISTO;
                if (ok) atomicAdd(&s_counts[bin], 1);
            }
            s_flag[q] = (uint8_t)((ok ? 0x80 : 0) | bin);
        }
    }
    __syncthreads();
    if (warp == 0) {
        // the third-largest count (with repeats, as torch.topk): three
        // rounds of a warp arg-max, each taking its first maximum out
        int c = lane < HISTO ? s_counts[lane] : -1;
        int third = 0;
        for (int r = 0; r < 3; ++r) {
            int v = c, i = lane;
            for (int off = 16; off > 0; off >>= 1) {
                const int ov = __shfl_xor_sync(0xffffffffu, v, off);
                const int oi = __shfl_xor_sync(0xffffffffu, i, off);
                if (ov > v || (ov == v && oi < i)) {
                    v = ov;
                    i = oi;
                }
            }
            if (i == lane) c = -1;
            third = v;
        }
        if (lane == 0) s_thresh = max(third, 1);
    }
    __syncthreads();
    for (int base = 0; base < a.n_a; base += NN_ROWS * NN_THREADS) {
        int j[NN_ROWS], bq[NN_ROWS];
#pragma unroll
        for (int u = 0; u < NN_ROWS; ++u) {
            const int q = base + u * NN_THREADS + tid;
            j[u] = q < a.n_a ? __ldcg(a.nn + q) : 0;
            bq[u] = q < a.n_a ? __ldcg(a.best + q) : 0;
        }
#pragma unroll
        for (int u = 0; u < NN_ROWS; ++u) {
            const int q = base + u * NN_THREADS + tid;
            if (q >= a.n_a) continue;
            const uint8_t fl = s_flag[q];
            const bool ok = (fl & 0x80) &&
                            (!angles || s_counts[fl & 0x7f] >= s_thresh);
            a.match[q] = ok ? j[u] : -1;
            a.dist[q] = ok ? bq[u] : BIG;
        }
    }
}

// ---- guided re-match count under the refined Sim3 (K16) ----------------
//
// Replaces the tail of place/loop_closer.py::_loop_geometry (:86-100 of
// the reference): each row's validity (keypoint valid, observed, its
// point valid), every point of ``cur`` moved by the refined Sim3
// (lie.sim3_apply) and projected (cameras.project_pinhole), the z > 0.05
// gate, and the number of rows with a valid keypoint of ``cand`` within
// 8 px (squared distance below r2) and 64 bits.  The plain version builds
// (F, F) distance and Hamming matrices in ~28 device operations.
//
// Bound: latency; the work is F x F window tests and, for the pairs inside
// the window, 8 XOR + popcounts.  Design: a warp a row of ``a``, 8 rows a
// CTA (125 CTAs at F = 1000: one wave), the lanes over ``b``.  Each CTA
// stages b's pixels, validity and descriptors in shared memory, up to
// GC_TILE keypoints a pass (41 bytes each), while its warps load their
// rows (the point's validity is a dependent gather).  A lane tests
// GC_UNROLL keypoints a step (their shared loads issued together), reads
// the descriptors of those inside the window, and the row ends at the
// first step in which a lane hits (__any_sync).  The projection rounds
// every operation as the plain version's eager torch ops do on the card
// (the cross products as one FMA over the rounded second product, as in
// csrc/track_pass.cu), so the count is exact.  Each CTA adds its rows to a
// device accumulator; the last CTA to take a self-resetting ticket writes
// the count and zeroes the accumulator: one launch, no memset.  Launches
// must not overlap (one stream).
constexpr int GC_WARPS = 8;
constexpr int GC_THREADS = 32 * GC_WARPS;
constexpr int GC_UNROLL = 4;  // keypoints a lane tests a step
constexpr int GC_TILE = 2048;  // keypoints staged a pass
constexpr int GC_STAGE = 32 + 8 + 1;  // bytes staged a keypoint
constexpr int GC_MAX_B = 65536;

__device__ unsigned g_guided_ticket;
__device__ int g_guided_sum;

struct GuidedArgs {
    const float* S;  // (8,): quaternion (w, x, y, z), translation, scale
    const float* cam;  // (4,): fx, fy, cx, cy
    const float* p_a;  // (n_a, 3) points of ``cur`` in its camera frame
    const int* obs_a;  // (n_a,) point ids or -1
    const uint8_t* kp_valid_a;  // (n_a,)
    const uint8_t* pt_valid;  // (n_pts,)
    const uint4* desc_a;  // (n_a, 2)
    const float2* uv_b;  // (n_b,)
    const uint8_t* valid_b;  // (n_b,)
    const uint4* desc_b;  // (n_b, 2)
    int n_a, n_b, n_pts, max_hd;
    float r2;
    int* count;
};

__device__ __forceinline__ void gc_cross(const float a[3], const float b[3],
                                         float c[3]) {
    c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
    c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
    c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

__global__ void __launch_bounds__(GC_THREADS)
guided_count_sim3_kernel(const GuidedArgs g) {
    // a pass's keypoints: descriptors (2 x 16 B), pixels, validity
    extern __shared__ uint4 s_desc[];
    const int tile = min(g.n_b, GC_TILE);
    float2* s_uv = reinterpret_cast<float2*>(s_desc + 2 * tile);
    uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_uv + tile);
    __shared__ int s_rows[GC_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int a = blockIdx.x * GC_WARPS + warp;

    // this warp's row (every lane the same), projected once
    bool row_ok = false;
    float u = 0.0f, v = 0.0f;
    uint4 da0 = make_uint4(0, 0, 0, 0), da1 = da0;
    if (a < g.n_a) {
        const int obs = g.obs_a[a];
        const bool kp = g.kp_valid_a[a] != 0;
        const float pa[3] = {g.p_a[3 * a], g.p_a[3 * a + 1],
                             g.p_a[3 * a + 2]};
        da0 = __ldg(g.desc_a + 2 * a);
        da1 = __ldg(g.desc_a + 2 * a + 1);
        // lie.sim3_apply: s (X + q0 u + qv x u) + t, u = 2 qv x X
        const float q0 = g.S[0];
        const float qv[3] = {g.S[1], g.S[2], g.S[3]};
        const float s = g.S[7];
        float c1[3], u1[3], c2[3], p[3];
        gc_cross(qv, pa, c1);
        for (int i = 0; i < 3; ++i) u1[i] = __fmul_rn(2.0f, c1[i]);
        gc_cross(qv, u1, c2);
        for (int i = 0; i < 3; ++i) {
            const float r = __fadd_rn(__fadd_rn(pa[i], __fmul_rn(q0, u1[i])),
                                      c2[i]);
            p[i] = __fadd_rn(__fmul_rn(s, r), g.S[4 + i]);
        }
        // cameras.project_pinhole, then the in-front gate
        const float z = p[2];
        const float iz = __frcp_rn(fabsf(z) < 1e-9f ? 1e-9f : z);
        u = __fadd_rn(__fmul_rn(__fmul_rn(g.cam[0], p[0]), iz), g.cam[2]);
        v = __fadd_rn(__fmul_rn(__fmul_rn(g.cam[1], p[1]), iz), g.cam[3]);
        row_ok = kp && obs >= 0 && obs < g.n_pts && g.pt_valid[obs] != 0 &&
                 z > 0.05f;
    }

    int hit = 0;
    for (int t0 = 0; t0 < g.n_b; t0 += GC_TILE) {
        const int nt = min(GC_TILE, g.n_b - t0);
        if (t0 > 0) __syncthreads();
#pragma unroll 4
        for (int i = tid; i < nt; i += GC_THREADS) {
            s_desc[2 * i] = __ldg(g.desc_b + 2 * (t0 + i));
            s_desc[2 * i + 1] = __ldg(g.desc_b + 2 * (t0 + i) + 1);
            s_uv[i] = g.uv_b[t0 + i];
            s_ok[i] = g.valid_b[t0 + i];
        }
        __syncthreads();
        if (!row_ok || hit) continue;
        for (int b0 = 0; b0 < nt; b0 += 32 * GC_UNROLL) {
            bool near[GC_UNROLL];
#pragma unroll
            for (int k = 0; k < GC_UNROLL; ++k) {
                const int b = b0 + 32 * k + lane;
                near[k] = false;
                if (b < nt && s_ok[b] != 0) {
                    const float2 kb = s_uv[b];
                    const float du = __fsub_rn(u, kb.x);
                    const float dv = __fsub_rn(v, kb.y);
                    near[k] = __fadd_rn(__fmul_rn(du, du),
                                        __fmul_rn(dv, dv)) < g.r2;
                }
            }
            bool h = false;
#pragma unroll
            for (int k = 0; k < GC_UNROLL; ++k) {
                if (near[k]) {
                    const int b = b0 + 32 * k + lane;
                    const uint4 e0 = s_desc[2 * b], e1 = s_desc[2 * b + 1];
                    const int d =
                        __popc(da0.x ^ e0.x) + __popc(da0.y ^ e0.y) +
                        __popc(da0.z ^ e0.z) + __popc(da0.w ^ e0.w) +
                        __popc(da1.x ^ e1.x) + __popc(da1.y ^ e1.y) +
                        __popc(da1.z ^ e1.z) + __popc(da1.w ^ e1.w);
                    h = h || d <= g.max_hd;
                }
            }
            if (__any_sync(0xffffffffu, h)) {
                hit = 1;
                break;
            }
        }
    }
    if (lane == 0) s_rows[warp] = hit;
    __syncthreads();
    if (tid == 0) {
        int rows = 0;
        for (int w = 0; w < GC_WARPS; ++w) rows += s_rows[w];
        if (rows != 0) atomicAdd(&g_guided_sum, rows);
        __threadfence();
        if (atomicInc(&g_guided_ticket, gridDim.x - 1) == gridDim.x - 1) {
            __threadfence();
            *g.count = atomicExch(&g_guided_sum, 0);
        }
    }
}

}  // namespace

// desc_*: (N, 32) u8 as (N, 8) u32 on a 16-byte boundary; valid_*: (N,)
// u8; angle_*: (N,) f32 or both NULL (no rotation histogram); n_b >= 1,
// n_a <= 36864;
// scratch: (3 n_a + n_b) i32, no fill needed.  Outputs match (n_a,) i32
// (-1 = none), dist (n_a,) i32 (10000 = none).  One launch.
VSG_API int vsg_match_nn_ratio(const uint32_t* desc_a, const uint8_t* valid_a,
                               const uint32_t* desc_b, const uint8_t* valid_b,
                               const float* angle_a, const float* angle_b,
                               int n_a, int n_b, float ratio, int max_dist,
                               int mutual, int* scratch, int* match,
                               int* dist, cudaStream_t stream) {
    if (n_a == 0) return 0;
    if (n_b < 1 || n_a > NN_MAX_A ||
        (((uintptr_t)desc_a | (uintptr_t)desc_b) & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    NNArgs a;
    a.desc_a = desc_a;
    a.valid_a = valid_a;
    a.desc_b = desc_b;
    a.valid_b = valid_b;
    a.angle_a = angle_a;
    a.angle_b = angle_b;
    a.n_a = n_a;
    a.n_b = n_b;
    a.row_ctas = (n_a + NN_QPC - 1) / NN_QPC;
    a.mutual = mutual;
    a.max_dist = max_dist;
    a.ratio = ratio;
    a.nn = scratch;
    a.best = scratch + n_a;
    a.second = scratch + 2 * n_a;
    a.back = scratch + 3 * n_a;
    a.match = match;
    a.dist = dist;
    const int col_ctas = mutual ? (n_b + NN_QPC - 1) / NN_QPC : 0;
    nn_ratio_kernel<<<a.row_ctas + col_ctas, NN_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// S: (8,) f32 Sim3 (q, t, s); cam: (4,) f32; p_a: (n_a, 3) f32; obs_a:
// (n_a,) i32; kp_valid_a, pt_valid, valid_b: u8; desc_*: (N, 32) u8 as
// (N, 8) u32 on a 16-byte boundary; uv_b: (n_b, 2) f32; n_b <= 65536; r2:
// the squared radius rounded to f32.  Output count: 0-d i32 (no fill
// needed).  One launch.
VSG_API int vsg_guided_count_sim3(const float* S, const float* cam,
                                  const float* p_a, const int* obs_a,
                                  const uint8_t* kp_valid_a,
                                  const uint8_t* pt_valid,
                                  const uint32_t* desc_a, const float* uv_b,
                                  const uint8_t* valid_b,
                                  const uint32_t* desc_b, int n_a, int n_b,
                                  int n_pts, float r2, int max_hd,
                                  int* count, cudaStream_t stream) {
    if (n_a < 0 || n_b < 0 || n_b > GC_MAX_B ||
        (((uintptr_t)desc_a | (uintptr_t)desc_b) & 15) != 0 ||
        ((uintptr_t)uv_b & 7) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)(n_b < GC_TILE ? n_b : GC_TILE) * GC_STAGE;
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            guided_count_sim3_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, GC_TILE * GC_STAGE);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    GuidedArgs g;
    g.S = S;
    g.cam = cam;
    g.p_a = p_a;
    g.obs_a = obs_a;
    g.kp_valid_a = kp_valid_a;
    g.pt_valid = pt_valid;
    g.desc_a = reinterpret_cast<const uint4*>(desc_a);
    g.uv_b = reinterpret_cast<const float2*>(uv_b);
    g.valid_b = valid_b;
    g.desc_b = reinterpret_cast<const uint4*>(desc_b);
    g.n_a = n_a;
    g.n_b = n_b;
    g.n_pts = n_pts;
    g.max_hd = max_hd;
    g.r2 = r2;
    g.count = count;
    const int ctas = n_a > 0 ? (n_a + GC_WARPS - 1) / GC_WARPS : 1;
    guided_count_sim3_kernel<<<ctas, GC_THREADS, smem, stream>>>(g);
    return (int)cudaGetLastError();
}

// desc_*: (N, 32) u8 viewed as (N, 8) u32; uv_*: (N, 2) f32; valid_*: (N,)
// u8; level_*: (N,) i32 or both NULL (no level band); r2: radius^2 rounded
// to f32; claimed: (n_b,) i32 filled with 10000 by the caller.
// Outputs match (n_a,) i32 (-1 = none) and dist (n_a,) i32 (10000 = none).
VSG_API int vsg_match_window(const uint32_t* desc_a, const float* uv_a,
                             const uint8_t* valid_a, const int* level_a,
                             const uint32_t* desc_b, const float* uv_b,
                             const uint8_t* valid_b, const int* level_b,
                             int n_a, int n_b, float r2, int level_slack,
                             float ratio, int max_dist, int* match,
                             int* dist, int* claimed, cudaStream_t stream) {
    if (n_a == 0) return 0;
    const int threads = 64;
    const int blocks = (n_a + threads - 1) / threads;
    match_pass1<<<blocks, threads, 0, stream>>>(
        desc_a, uv_a, valid_a, level_a, desc_b, uv_b, valid_b, level_b,
        n_a, n_b, r2, level_slack, ratio, max_dist, match, dist, claimed);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    match_pass2<<<blocks, threads, 0, stream>>>(n_a, claimed, match, dist);
    return (int)cudaGetLastError();
}
