// K29: point and keyframe culling, one launch.
//
// Replaces visual_sgraphs_tpu/slam/mapping.py:685 cull_points followed by
// :650 cull_keyframes with its retirement (:45), which the port ran as
// ~34 and ~150 eager torch operations (slam/mapping.py):
//   nobs = point_obs_count(m); a point is bad when valid and (3 keyframes
//   old with fewer than min_obs observations, or at most 3 old, seen >= 8
//   times and found / visible < min_found_ratio); bad points are
//   invalidated, their freed sequence set, every link to them unlinked;
//   then on that map: kf's covisibility counts, each keyframe's share of
//   its valid observations whose point 4 or more valid keyframes observe,
//   the first covisible keyframe (not 0, not kf) whose share is above
//   `redundancy`, and its retirement (ledger, parent, pt_first_kf).
// Written out of place: kf_valid, kf_obs_pt, pt_valid, pt_first_kf,
// pt_freed_seq, the ledger, and the culled slot or -1.
//
// The second pass needs no second count: unlinking removes exactly the
// links to bad points, so after it a bad point has no observation and
// every other point keeps its count; a bad point is invalid afterwards,
// so the second pass's tests on the original links (valid point, count,
// membership in kf's row) equal its tests on the unlinked ones.
//
// What bounds it here: latency.  It reads the (K, F) observation ids and
// flags (~640 KB at 128 x 1000) and the point tables (~0.6 MB at N =
// 32768) and writes kf_obs_pt and three point tables (~0.8 MB).
//
// Design: one cluster of 8 CTAs of 1024 threads.  The (N,) counters are
// split three ways: CTA r counts the observations of its 1/8 of the rows
// into a private (N,) int array in shared memory (128 KB at N = 32768:
// shared atomics, no contention with other SMs), and after a cluster
// barrier sums its 1/8 of the points across the 8 arrays through
// distributed shared memory, tests them (a thread a point) and publishes
// three bitmaps of its slice (bad, valid after the cull, 4 or more
// observations: a warp ballot a word).  One CTA alone would read the
// observations and points through one SM; the cluster spreads both over
// eight.  After a second barrier each CTA gathers the full bitmaps,
// builds kf's membership bitmap, unlinks and counts its rows (shared
// atomics), and sends each row's drop flag to every CTA; after a third,
// each CTA finds the first drop and the parent, moves its slice's
// pt_first_kf and its part of the ledger, and CTA 0 writes kf_valid and
// the slot.
#include <cooperative_groups.h>

#include "common.cuh"
#include "lie_rn.cuh"
#include "map_maint.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 8;
constexpr int MAX_ROWS = 128;  // rows a CTA: K <= 1024

struct CullDims {
    int K, F, N, E, kf, min_obs;
    float min_found_ratio, redundancy;
};

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
map_cull_kernel(MapPtrs in, MapPtrs out, CullDims d, int* culled) {
    const int K = d.K, F = d.F, N = d.N, kf = d.kf;
    const int n_words = (N + 31) >> 5;
    const int sw = (n_words + CLUSTER - 1) / CLUSTER;  // words a slice
    extern __shared__ uint32_t sh[];
    int* cnt = reinterpret_cast<int*>(sh);  // (N) this CTA's rows' counts
    uint32_t* bad_b = sh + N;
    uint32_t* valid_b = bad_b + n_words;  // valid after the cull
    uint32_t* ge4_b = valid_b + n_words;  // 4 or more observations after it
    uint32_t* member_b = ge4_b + n_words;  // kf's points, valid after it
    uint8_t* drop = reinterpret_cast<uint8_t*>(member_b + n_words);  // (K)
    __shared__ int n_ok[MAX_ROWS], n_red[MAX_ROWS], n_cov[MAX_ROWS];
    __shared__ int ws[32];
    __shared__ Retire ret;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31;
    const int per = (K + CLUSTER - 1) / CLUSTER;
    const int r0 = min(K, rank * per), r1 = min(K, r0 + per);
    const int w0 = min(n_words, rank * sw), w1 = min(n_words, w0 + sw);

    const int* obs = in.at<int>(KF_OBS_PT);
    const uint8_t* kp_valid = in.at<uint8_t>(KF_KP_VALID);
    const uint8_t* kf_valid = in.at<uint8_t>(KF_VALID);
    const int n_kf = *in.at<int>(N_KF);

    // ---- A. this CTA's rows' observation counts
    for (int p = tid; p < N; p += THREADS) cnt[p] = 0;
    for (int r = tid; r < per; r += THREADS) {
        n_ok[r] = 0;
        n_red[r] = 0;
        n_cov[r] = 0;
    }
    __syncthreads();
    mm_obs_count_rows(obs, kp_valid, kf_valid, F, N, r0, r1, cnt);
    mm_cluster_sync();

    // ---- B. the slice's points: counts summed over the cluster, the test
    {
        const uint8_t* valid = in.at<uint8_t>(PT_VALID);
        const int* first_seq = in.at<int>(PT_FIRST_SEQ);
        const int* found = in.at<int>(PT_FOUND);
        const int* visible = in.at<int>(PT_VISIBLE);
        const int* freed = in.at<int>(PT_FREED_SEQ);
        uint8_t* valid_o = out.at<uint8_t>(PT_VALID);
        int* freed_o = out.at<int>(PT_FREED_SEQ);
        const int* peer[CLUSTER];
        for (int r = 0; r < CLUSTER; ++r) {
            peer[r] = cluster.map_shared_rank(cnt, r);
        }
        // a warp a 32-point word: its flags by ballot
        for (int base = 32 * w0 + (tid & ~31); base < 32 * w1;
             base += THREADS) {
            const int p = base + lane;
            bool bad = false, v_after = false, ge4 = false;
            if (p < N) {
                int nobs = 0;
                for (int r = 0; r < CLUSTER; ++r) nobs += peer[r][p];
                const int age = n_kf - first_seq[p];
                const int vis = visible[p];
                const float ratio = __fdiv_rn((float)found[p],
                                              fmaxf((float)vis, 1.0f));
                const bool low = age <= 3 && vis >= 8 &&
                                 ratio < d.min_found_ratio;
                const bool v = valid[p] != 0;
                bad = v && ((age >= 3 && nobs < d.min_obs) || low);
                v_after = v && !bad;
                ge4 = !bad && nobs >= 4;
                valid_o[p] = v_after;
                freed_o[p] = bad ? n_kf : freed[p];
            }
            const uint32_t wb = __ballot_sync(0xffffffffu, bad);
            const uint32_t wv = __ballot_sync(0xffffffffu, v_after);
            const uint32_t wg = __ballot_sync(0xffffffffu, ge4);
            if (lane == 0) {
                bad_b[base >> 5] = wb;
                valid_b[base >> 5] = wv;
                ge4_b[base >> 5] = wg;
            }
        }
    }
    mm_cluster_sync();

    // ---- C. the full bitmaps, kf's valid points
    for (int w = tid; w < n_words; w += THREADS) {
        member_b[w] = 0u;
        if (w >= w0 && w < w1) continue;
        const int owner = w / sw;
        bad_b[w] = cluster.map_shared_rank(bad_b, owner)[w];
        valid_b[w] = cluster.map_shared_rank(valid_b, owner)[w];
        ge4_b[w] = cluster.map_shared_rank(ge4_b, owner)[w];
    }
    __syncthreads();
    mm_mark_row(obs + (long long)kf * F, kp_valid + (long long)kf * F, F, N,
                member_b);
    __syncthreads();
    for (int w = tid; w < n_words; w += THREADS) member_b[w] &= valid_b[w];
    __syncthreads();

    // ---- D. this CTA's rows: unlink, count, each row's drop flag
    {
        int* obs_o = out.at<int>(KF_OBS_PT);
        const long long first = (long long)r0 * F, total = (long long)r1 * F;
        for (long long e = first + tid; e < total; e += THREADS) {
            const int id = obs[e];
            const bool in_range = id >= 0 && id < N;
            const bool is_bad = in_range && mm_bit(bad_b, id);
            obs_o[e] = is_bad ? -1 : id;
            if (!kp_valid[e] || !in_range) continue;
            const int r = (int)(e / F) - r0;
            if (mm_bit(valid_b, id)) {
                atomicAdd(n_ok + r, 1);
                if (mm_bit(ge4_b, id)) atomicAdd(n_red + r, 1);
            }
            if (mm_bit(member_b, id)) atomicAdd(n_cov + r, 1);
        }
        __syncthreads();
        for (int r = r0 + tid; r < r1; r += THREADS) {
            const int i = r - r0;
            const bool v = kf_valid[r] != 0;
            const int cov = (v && r != kf) ? n_cov[i] : 0;
            const bool cand = cov > 0 && v && r != 0 && r != kf;
            const float ratio = __fdiv_rn((float)n_red[i],
                                          (float)max(n_ok[i], 1));
            const uint8_t f = cand && ratio > d.redundancy && n_ok[i] > 0;
            for (int c = 0; c < CLUSTER; ++c) {
                cluster.map_shared_rank(drop, c)[r] = f;
            }
        }
    }
    mm_cluster_sync();

    // ---- E. the first drop, its retirement
    int first = K;
    for (int r = tid; r < K; r += THREADS) {
        if (drop[r]) {
            first = r;
            break;
        }
    }
    first = -mm_block_max(-first, ws);
    const bool act = first < K;
    const int slot = act ? first : 0;
    mm_plan_retire(kf_valid, in.at<int>(KF_SEQ), K, slot, act,
                   in.at<int>(LED_N), d.E, &ret);
    __syncthreads();
    {
        const int* first_kf = in.at<int>(PT_FIRST_KF);
        int* first_kf_o = out.at<int>(PT_FIRST_KF);
        const int p1 = min(N, 32 * w1);
        for (int p = 32 * w0 + tid; p < p1; p += THREADS) {
            first_kf_o[p] = mm_retire_first_kf(ret, first_kf[p]);
        }
    }
    if (rank == 0) {
        uint8_t* kf_valid_o = out.at<uint8_t>(KF_VALID);
        for (int r = tid; r < K; r += THREADS) {
            kf_valid_o[r] = (act && r == slot) ? 0 : kf_valid[r];
        }
        if (tid == 0) *culled = act ? slot : -1;
    }
    mm_write_ledger(ret, in.at<int>(KF_SEQ), in.at<float>(KF_POSE),
                    in.at<int>(LED_SEQ), in.at<int>(LED_PARENT_SEQ),
                    in.at<float>(LED_T_CP), in.at<int>(LED_N), d.E,
                    out.at<int>(LED_SEQ), out.at<int>(LED_PARENT_SEQ),
                    out.at<float>(LED_T_CP), out.at<int>(LED_N), rank,
                    CLUSTER);
}

}  // namespace

// The shared memory K29 needs at (K, N): the (N,) counts, four N-bit
// bitmaps and K drop flags
VSG_API long long vsg_map_cull_smem(int K, int N) {
    const long long n_words = (N + 31) / 32;
    return 4LL * N + 16LL * n_words + ((K + 3) & ~3);
}

// in, out: the map's 25 field pointers in MapState's order (out: kf_valid,
// kf_obs_pt, pt_valid, pt_first_kf, pt_freed_seq and the ledger's four;
// the rest null); kf: the keyframe; culled: () i32
VSG_API int vsg_map_cull(void* const* in, void* const* out, int K, int F,
                         int N, int E, int kf, int min_obs,
                         float min_found_ratio, float redundancy,
                         int* culled, cudaStream_t stream) {
    if (kf < 0 || kf >= K || K > MAX_ROWS * CLUSTER || F <= 0 || N <= 0 ||
        E <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)vsg_map_cull_smem(K, N);
    static size_t set = 0;
    if (smem > 48 * 1024 && smem > set) {
        const cudaError_t e = cudaFuncSetAttribute(
            map_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        set = smem;
    }
    map_cull_kernel<<<CLUSTER, THREADS, smem, stream>>>(
        mm_map(in), mm_map(out),
        CullDims{K, F, N, E, kf, min_obs, min_found_ratio, redundancy},
        culled);
    return (int)cudaGetLastError();
}
