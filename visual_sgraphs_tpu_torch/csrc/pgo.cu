// K19: linearisation and dense normal-equation assembly of the Sim3 pose
// graph (essential graph of loop closing), and its cost.
//
// Replaces the assembly that visual_sgraphs_tpu/place/pgo.py::
// optimize_essential_graph runs through optim/solve.py::_assemble and
// ::problem_cost: per edge, the relative_sim3 residual
// r = log(S_meas^-1 . S_j . S_i^-1) (optim/factors.py:99) and its two 7x7
// Jacobians by jax.jacfwd through the sim3_boxplus retraction, then the
// scatter of w J_i^T J_j and w J_i^T r into a dense (7K, 7K) system.
//
// What bounds it here: operations and latency.  E <= 513 edges, each a
// chain of Sim3 exp / multiply / inverse / log (~2k flops) evaluated for
// 14 tangent directions, then 196 products into H; the (896, 896) f32
// system (3.2 MB) is touched only where edges land.
//
// Design: one warp per edge; lane l < 14 evaluates the residual with a
// dual number seeded on tangent direction l (7 of keyframe i, then 7 of
// keyframe j) through the same branches of so3_log and the Sim3 W terms
// as the reference (lie.cuh), which is what forward-mode AD computes; the
// scale directions are zero when the scale is fixed (the retraction
// zeroes that tangent component, pgo.py:176-183, and H keeps its rows).
// Lane a then gathers the other columns by shuffles and adds its row of
// w J^T J and its entry of w J^T r with f32 atomics.  The cost entry
// point evaluates the plain residuals, one thread per edge, and reduces
// info * |r|^2 over valid edges in one block in a fixed order, so the LM
// accept compares deterministic sums.
#include "lie.cuh"

namespace {

template <typename T>
__device__ void edge_residual(const T* Si, const T* Sj, const float* Sm,
                              T* r) {
    T inv_i[8], Sji[8], inv_m[8], E[8], Sm_t[8];
    for (int k = 0; k < 8; ++k) Sm_t[k] = cst<T>(Sm[k]);
    sim3_inv(Si, inv_i);
    sim3_mul(Sj, inv_i, Sji);
    sim3_inv(Sm_t, inv_m);
    sim3_mul(inv_m, Sji, E);
    sim3_log(E, r);
}

__global__ void pgo_assemble_kernel(const float* __restrict__ S,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ Smeas,
                                    const float* __restrict__ info,
                                    const uint8_t* __restrict__ valid,
                                    int E, int D, int fix_scale,
                                    float* __restrict__ H,
                                    float* __restrict__ g) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= E) return;  // whole warps leave together
    if (!valid[warp]) return;
    const int vi = idx[2 * warp], vj = idx[2 * warp + 1];
    const float sq = sqrtf(info[warp]);
    Dual Si[8], Sj[8];
    {
        // the retraction exp(d) . S at d = 0, seeded on direction ``lane``
        Dual di[7], dj[7];
        const bool scale_dir = (lane % 7) == 6;
        const float seed = (lane < 14 && !(fix_scale && scale_dir)) ? 1.0f
                                                                     : 0.0f;
        for (int k = 0; k < 7; ++k) {
            di[k] = mkd(0.0f, (lane == k) ? seed : 0.0f);
            dj[k] = mkd(0.0f, (lane == 7 + k) ? seed : 0.0f);
        }
        Dual Ei[8], Ej[8], Si0[8], Sj0[8];
        for (int k = 0; k < 8; ++k) {
            Si0[k] = mkd(S[8 * vi + k]);
            Sj0[k] = mkd(S[8 * vj + k]);
        }
        sim3_exp(di, Ei);
        sim3_exp(dj, Ej);
        sim3_mul(Ei, Si0, Si);
        sim3_mul(Ej, Sj0, Sj);
    }
    Dual r[7];
    edge_residual(Si, Sj, Smeas + 8 * warp, r);
    float rv[7], Jc[7];
    for (int k = 0; k < 7; ++k) {
        rv[k] = sq * r[k].v;
        Jc[k] = sq * r[k].d;  // column ``lane`` of [J_i | J_j]
    }
    const int row = lane < 14 ? (lane < 7 ? 7 * vi + lane : 7 * vj + lane - 7)
                              : 0;
    float gsum = 0.0f;
    for (int k = 0; k < 7; ++k) gsum += Jc[k] * rv[k];
    if (lane < 14 && gsum != 0.0f) atomicAdd(&g[row], gsum);
    for (int b = 0; b < 14; ++b) {
        float h = 0.0f;
        for (int k = 0; k < 7; ++k) {
            h += Jc[k] * __shfl_sync(0xffffffffu, Jc[k], b);
        }
        const int col = b < 7 ? 7 * vi + b : 7 * vj + b - 7;
        if (lane < 14 && h != 0.0f) {
            atomicAdd(&H[(size_t)row * D + col], h);
        }
    }
}

__global__ void pgo_cost_kernel(const float* __restrict__ S,
                                const int* __restrict__ idx,
                                const float* __restrict__ Smeas,
                                const float* __restrict__ info,
                                const uint8_t* __restrict__ valid, int E,
                                float* __restrict__ out) {
    __shared__ float scratch[32];
    float s = 0.0f;
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        if (!valid[e]) continue;
        const int vi = idx[2 * e], vj = idx[2 * e + 1];
        float r[7];
        edge_residual(S + 8 * vi, S + 8 * vj, Smeas + 8 * e, r);
        float c = 0.0f;
        for (int k = 0; k < 7; ++k) c += r[k] * r[k];
        s += info[e] * c;
    }
    s = vsg_warp_sum(s);
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float t = 0.0f;
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += scratch[i];
        *out = t;
    }
}

}  // namespace

// S: (K, 8) Sim3 values; idx: (E, 2) i32 variable rows; Smeas: (E, 8)
// measured S_ji; info: (E,) f32; valid: (E,) u8.  H (7K, 7K) and g (7K,)
// f32 zero-filled by the caller: H += sum w J^T J, g += sum w J^T r.
VSG_API int vsg_pgo_assemble(const float* S, const int* idx,
                             const float* Smeas, const float* info,
                             const uint8_t* valid, int E, int K,
                             int fix_scale, float* H, float* g,
                             cudaStream_t stream) {
    if (E == 0) return 0;
    const int threads = 128;
    const int blocks = (E * 32 + threads - 1) / threads;
    pgo_assemble_kernel<<<blocks, threads, 0, stream>>>(
        S, idx, Smeas, info, valid, E, 7 * K, fix_scale, H, g);
    return (int)cudaGetLastError();
}

// Same operands; out: 0-d f32 sum over valid edges of info * |r|^2.
VSG_API int vsg_pgo_cost(const float* S, const int* idx, const float* Smeas,
                         const float* info, const uint8_t* valid, int E,
                         float* out, cudaStream_t stream) {
    pgo_cost_kernel<<<1, 512, 0, stream>>>(S, idx, Smeas, info, valid, E,
                                           out);
    return (int)cudaGetLastError();
}
