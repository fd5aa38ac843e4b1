// K24: plane association, the per-keyframe update of the scene graph's
// plane and observation tables by the keyframe's detected planes.
//
// Replaces visual_sgraphs_tpu/scenegraph/manager.py:51::
// associate_and_update (jitted with static n_det = 4).  For each detection
// in turn (detection k sees what detection k - 1 matched or created): the
// chart distance (azimuth, elevation, distance; core/plane.py::ominus) to
// every map plane and the centroid distance; among the valid planes within
// the thresholds the first arg-min of |(az, el)| + |dist|; a match blends
// the plane in its own chart (oplus of alpha ominus, alpha = w_new /
// (w_old + w_new)) and its centroid, and adds the support, votes and one
// observation; an unmatched valid detection takes slot min(n_planes,
// P - 1) while n_planes < P; the detection's surface voxel keys overwrite
// row max(plane_id, 0) of the plane's voxel table; the observation record
// goes to slot min(n_obs, Q - 1) while n_obs < Q, with conf = sum(votes) /
// max(npts, 1) and the keyframe id, a launch argument.
//
// What bounds it here: latency.  The arithmetic is ~n_det x P chart
// distances (two atan2, four sin / cos each) and n_det x V voxel merges;
// the bytes are the tables, which the function returns as new tensors:
// ~220 KB read and written at P = 64, V = 512, Q = 1024.  The reference
// runs ~60 dependent small operations a detection.
//
// Design: one launch of one cluster of 8 CTAs of 512 threads.  CTAs 1-7
// copy the voxel and observation tables to the outputs with 16-byte
// loads, every thread's loads issued together.  Meanwhile CTA 0 stages
// the plane table and computes the whole n_det x P score table in
// parallel (a thread a pair; each plane's rotation kept for the blend):
// detection k's score against a plane that no earlier detection matched
// or created does not depend on the order.  Then warp 0 resolves the
// detections in order: the lanes recompute only the planes an earlier
// detection changed, take the first arg-min by shuffles (jnp.argmin's
// order), and lane 0 applies the blend (from the stored chart distance
// and rotation), allocation and observation slot.  A cluster barrier
// (release / acquire) orders the copies before CTA 0's writes: the plane
// table, the observation records, and the voxel keys, a thread a key
// walking the detections in order (a later detection on the same plane
// overwrites an earlier one, as in the reference's sequence).  The chart
// uses atan2f and sincosf, and the rotation's cosines and sines come from
// the normal's components; both differ from the twin's trigonometry in
// the last ulps, so coefficients and centroids agree within 1e-5; every
// integer field is exact unless a score lies within an ulp of a threshold
// or of another plane's.  Bitwise from launch to launch.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCtas = 8;  // the cluster: CTA 0 resolves, 1..7 copy
constexpr int kMaxP = 128;
constexpr int kMaxDet = 16;
constexpr int kCopy = 4;  // 16-byte chunks a copying thread has in flight

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// R = Rz(azimuth) Ry(-elevation) of normal v, row-major (plane3d.h:64-71),
// the cosines and sines of azimuth = atan2(v1, v0) and elevation =
// atan2(v2, |(v0, v1)|) taken from v's components (no trigonometric call
// on the resolution's serial chain; atan2(0, 0) = 0)
__device__ void normal_rotation(const float* v, float* R) {
    const float h = sqrtf(v[0] * v[0] + v[1] * v[1]);
    const float r = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    const float ca = h > 0.0f ? v[0] / h : 1.0f;
    const float sa = h > 0.0f ? v[1] / h : 0.0f;
    const float ce = r > 0.0f ? h / r : 1.0f;
    const float se = r > 0.0f ? v[2] / r : 0.0f;
    R[0] = ca * ce;
    R[1] = -sa;
    R[2] = -ca * se;
    R[3] = sa * ce;
    R[4] = ca;
    R[5] = -sa * se;
    R[6] = se;
    R[7] = 0.0f;
    R[8] = ce;
}

// Chart coordinates of plane ``other`` relative to plane ``ref``, whose
// normal_rotation is R
__device__ void ominus_R(const float* R, const float* ref, const float* other,
                         float* out) {
    float n[3];
    for (int k = 0; k < 3; ++k) {
        n[k] = R[k] * other[0] + R[3 + k] * other[1] + R[6 + k] * other[2];
    }
    out[0] = atan2f(n[1], n[0]);
    out[1] = atan2f(n[2], sqrtf(n[0] * n[0] + n[1] * n[1]));
    out[2] = -other[3] - -ref[3];
}

// The plane ``coeffs`` (normal_rotation R) moved by the chart perturbation
// ``delta``, normalised (plane3d.h:73-89)
__device__ void oplus_R(const float* R, const float* coeffs,
                        const float* delta, float* out) {
    float s, c, s0, c0;
    sincosf(delta[1], &s, &c);
    sincosf(delta[0], &s0, &c0);
    const float nl[3] = {c * c0, c * s0, s};
    float v[4];
    for (int i = 0; i < 3; ++i) {
        v[i] = R[3 * i] * nl[0] + R[3 * i + 1] * nl[1] + R[3 * i + 2] * nl[2];
    }
    v[3] = -(-coeffs[3] + delta[2]);
    const float nrm = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                            1.17549435e-38f);
    for (int k = 0; k < 4; ++k) out[k] = v[k] / nrm;
}

struct Tables {
    // planes (P,): coeffs (P, 4), valid, centroid (P, 3), npts, votes
    // (P, 3), nobs, n_planes; voxel keys (P, V)
    const float* coeffs;
    const uint8_t* valid;
    const float* centroid;
    const float* npts;
    const float* votes;
    const int* nobs;
    const int* n_planes;
    const int* vox;
    // observations (Q,): kf, plane, coeffs (Q, 4), conf, quadric (Q, 16),
    // valid, n_obs
    const int* ob_kf;
    const int* ob_plane;
    const float* ob_coeffs;
    const float* ob_conf;
    const float* ob_quadric;
    const uint8_t* ob_valid;
    const int* n_obs;
};

struct OutTables {
    float* coeffs;
    uint8_t* valid;
    float* centroid;
    float* npts;
    float* votes;
    int* nobs;
    int* n_planes;
    int* vox;
    int* ob_kf;
    int* ob_plane;
    float* ob_coeffs;
    float* ob_conf;
    float* ob_quadric;
    uint8_t* ob_valid;
    int* n_obs;
};

struct Detections {
    // (n_det, 4) world planes, (n_det,) bool, (n_det, 3), (n_det,),
    // (n_det, 3), (n_det, 4) camera-frame planes, (n_det, 16) or null,
    // (n_det, V) or null
    const float* coeffs;
    const uint8_t* valid;
    const float* centroid;
    const float* npts;
    const float* votes;
    const float* local;
    const float* quadric;
    const int* vox;
};

// The tables CTAs 1.. copy unchanged: voxel keys and observations, each
// (src, dst, bytes) with 16-byte aligned pointers
struct CopyList {
    const char* src[7];
    char* dst[7];
    int bytes[7];
};

// CTAs 1.. : every 16-byte chunk of the seven tables, a thread kCopy chunks
// a round with all its loads issued before its stores
__device__ void copy_tables(const CopyList& cl, int rank, int n_ranks) {
    int chunks[8];
    chunks[0] = 0;
    for (int t = 0; t < 7; ++t) {
        chunks[t + 1] = chunks[t] + (cl.bytes[t] + 15) / 16;
    }
    const int total = chunks[7];
    const int stride = n_ranks * kThreads;
    for (int base = rank * kThreads + threadIdx.x; base < total;
         base += kCopy * stride) {
        uint4 v[kCopy];
        int tab[kCopy], off[kCopy];
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
            const int c = base + u * stride;
            int t = 0;
            while (t < 6 && c >= chunks[t + 1]) ++t;
            tab[u] = c < total ? t : -1;
            off[u] = c - chunks[t];
            if (tab[u] >= 0 && 16 * (off[u] + 1) <= cl.bytes[t]) {
                v[u] = __ldg(reinterpret_cast<const uint4*>(cl.src[t]) +
                             off[u]);
            }
        }
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
            const int t = tab[u];
            if (t < 0) continue;
            if (16 * (off[u] + 1) <= cl.bytes[t]) {
                reinterpret_cast<uint4*>(cl.dst[t])[off[u]] = v[u];
            } else {
                for (int b = 16 * off[u]; b < cl.bytes[t]; ++b) {
                    cl.dst[t][b] = cl.src[t][b];
                }
            }
        }
    }
}

// detection ``det``'s score against plane p (rotation R, table entries as
// staged) and its chart distance ``om``
__device__ float pair_score(const float* R, const float* ref,
                            const float* cen, bool valid, const float* det,
                            const float* dc, float ominus_thresh,
                            float dist_thresh, float centroid_thresh,
                            float* om) {
    ominus_R(R, ref, det, om);
    const float ang = sqrtf(om[0] * om[0] + om[1] * om[1]);
    const float dd = fabsf(om[2]);
    const float dx = cen[0] - dc[0], dy = cen[1] - dc[1], dz = cen[2] - dc[2];
    const float cdist = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool cand = valid && ang < ominus_thresh && dd < dist_thresh
                      && cdist < centroid_thresh;
    return cand ? ang + dd : INFINITY;
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads)
plane_assoc_kernel(Tables in, OutTables out, Detections det, CopyList cl,
                   int n_det, int P, int V, int Q, int kf_id,
                   float ominus_thresh, float dist_thresh,
                   float centroid_thresh) {
    __shared__ float s_coeffs[kMaxP][4], s_cen[kMaxP][3], s_npts[kMaxP],
        s_votes[kMaxP][3], s_R[kMaxP][9];
    __shared__ int s_nobs[kMaxP];
    __shared__ uint8_t s_valid[kMaxP], s_dirty[kMaxP];
    __shared__ float s_det[kMaxDet][4], s_dc[kMaxDet][3],
        s_dvotes[kMaxDet][3], s_dnpts[kMaxDet];
    __shared__ uint8_t s_dok[kMaxDet];
    __shared__ float s_score[kMaxDet][kMaxP], s_om[kMaxDet][kMaxP][3];
    __shared__ int s_pid[kMaxDet], s_oslot[kMaxDet];
    __shared__ int s_n_planes, s_n_obs;
    const int tid = threadIdx.x;
    const int rank = blockIdx.x;

    if (rank != 0) {
        copy_tables(cl, rank - 1, kCtas - 1);
        cluster_arrive();
        cluster_wait();
        return;
    }

    // ---- CTA 0: stage the plane table and the detections
    for (int p = tid; p < P; p += kThreads) {
        for (int k = 0; k < 4; ++k) s_coeffs[p][k] = in.coeffs[4 * p + k];
        for (int k = 0; k < 3; ++k) {
            s_cen[p][k] = in.centroid[3 * p + k];
            s_votes[p][k] = in.votes[3 * p + k];
        }
        s_npts[p] = in.npts[p];
        s_nobs[p] = in.nobs[p];
        s_valid[p] = in.valid[p];
        s_dirty[p] = 0;
    }
    for (int i = tid; i < n_det; i += kThreads) {
        for (int k = 0; k < 4; ++k) s_det[i][k] = det.coeffs[4 * i + k];
        for (int k = 0; k < 3; ++k) {
            s_dc[i][k] = det.centroid[3 * i + k];
            s_dvotes[i][k] = det.votes[3 * i + k];
        }
        s_dnpts[i] = det.npts[i];
        s_dok[i] = det.valid[i];
    }
    if (tid == 0) {
        s_n_planes = *in.n_planes;
        s_n_obs = *in.n_obs;
    }
    // the voxel keys this thread writes after the resolution
    int keys[kMaxDet];
#pragma unroll
    for (int i = 0; i < kMaxDet; ++i) {
        keys[i] = (det.vox != nullptr && i < n_det && tid < V)
                      ? det.vox[(size_t)i * V + tid] : -1;
    }
    __syncthreads();

    // ---- the n_det x P score table against the staged planes, a thread a
    // pair; detection 0's threads keep each plane's rotation
    for (int q = tid; q < n_det * P; q += kThreads) {
        const int i = q / P, p = q % P;
        float R[9], om[3];
        normal_rotation(s_coeffs[p], R);
        s_score[i][p] = pair_score(R, s_coeffs[p], s_cen[p], s_valid[p],
                                   s_det[i], s_dc[i], ominus_thresh,
                                   dist_thresh, centroid_thresh, om);
        for (int k = 0; k < 3; ++k) s_om[i][p][k] = om[k];
        if (i == 0) {
            for (int k = 0; k < 9; ++k) s_R[p][k] = R[k];
        }
    }
    __syncthreads();

    // ---- warp 0 resolves the detections in order
    if (tid < 32) {
        const int lane = tid;
        for (int i = 0; i < n_det; ++i) {
            float v = INFINITY;
            int b = INT_MAX;
            for (int p = lane; p < P; p += 32) {
                float sc = s_score[i][p];
                if (s_dirty[p]) {
                    // matched or created by an earlier detection
                    float R[9], om[3];
                    normal_rotation(s_coeffs[p], R);
                    sc = pair_score(R, s_coeffs[p], s_cen[p], s_valid[p],
                                    s_det[i], s_dc[i], ominus_thresh,
                                    dist_thresh, centroid_thresh, om);
                    for (int k = 0; k < 3; ++k) s_om[i][p][k] = om[k];
                    for (int k = 0; k < 9; ++k) s_R[p][k] = R[k];
                }
                if (vsg_better<false>(sc, p, v, b)) {
                    v = sc;
                    b = p;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, v, off);
                const int ob = __shfl_xor_sync(0xffffffffu, b, off);
                if (vsg_better<false>(ov, ob, v, b)) {
                    v = ov;
                    b = ob;
                }
            }
            __syncwarp();
            if (lane == 0) {
                const bool ok = s_dok[i] != 0;
                const bool matched = ok && isfinite(v);
                const float npts = s_dnpts[i];
                const float* coeffs = s_det[i];
                const float* dc = s_dc[i];
                if (matched) {
                    // running weighted average in the chart of the old plane
                    const float w_old = fmaxf(s_npts[b], 1.0f);
                    const float w_new = fmaxf(npts, 1.0f);
                    const float alpha = w_new / (w_old + w_new);
                    float om[3], blended[4];
                    for (int k = 0; k < 3; ++k) om[k] = alpha * s_om[i][b][k];
                    oplus_R(s_R[b], s_coeffs[b], om, blended);
                    for (int k = 0; k < 4; ++k) s_coeffs[b][k] = blended[k];
                    for (int k = 0; k < 3; ++k) {
                        s_cen[b][k] = s_cen[b][k] * (1.0f - alpha) +
                                      dc[k] * alpha;
                        s_votes[b][k] += s_dvotes[i][k];
                    }
                    s_npts[b] += npts;
                    s_nobs[b] += 1;
                    s_dirty[b] = 1;
                }
                const int n_pl = s_n_planes;
                const int slot = min(n_pl, P - 1);
                const bool alloc = ok && !matched && n_pl < P;
                if (alloc) {
                    for (int k = 0; k < 4; ++k) s_coeffs[slot][k] = coeffs[k];
                    for (int k = 0; k < 3; ++k) {
                        s_cen[slot][k] = dc[k];
                        s_votes[slot][k] += s_dvotes[i][k];
                    }
                    s_valid[slot] = 1;
                    s_npts[slot] += npts;
                    s_nobs[slot] += 1;
                    s_dirty[slot] = 1;
                    s_n_planes = n_pl + 1;
                }
                const int plane_id = matched ? b : alloc ? slot : -1;
                const int n_ob = s_n_obs;
                const bool rec = plane_id >= 0 && n_ob < Q;
                s_pid[i] = plane_id;
                s_oslot[i] = rec ? min(n_ob, Q - 1) : -1;
                if (rec) s_n_obs = n_ob + 1;
            }
            __syncwarp();
        }
    }
    __syncthreads();

    // ---- after the copies: the plane table, the records, the voxel keys
    cluster_arrive();
    cluster_wait();
    for (int p = tid; p < P; p += kThreads) {
        for (int k = 0; k < 4; ++k) out.coeffs[4 * p + k] = s_coeffs[p][k];
        for (int k = 0; k < 3; ++k) {
            out.centroid[3 * p + k] = s_cen[p][k];
            out.votes[3 * p + k] = s_votes[p][k];
        }
        out.npts[p] = s_npts[p];
        out.nobs[p] = s_nobs[p];
        out.valid[p] = s_valid[p];
    }
    if (tid == 0) {
        *out.n_planes = s_n_planes;
        *out.n_obs = s_n_obs;
    }
    for (int i = tid; i < n_det; i += kThreads) {
        const int oslot = s_oslot[i];
        if (oslot < 0) continue;
        const float* vt = s_dvotes[i];
        out.ob_kf[oslot] = kf_id;
        out.ob_plane[oslot] = s_pid[i];
        for (int k = 0; k < 4; ++k) {
            out.ob_coeffs[4 * oslot + k] = det.local[4 * i + k];
        }
        out.ob_conf[oslot] = (vt[0] + vt[1] + vt[2]) / fmaxf(s_dnpts[i], 1.0f);
        for (int k = 0; k < 16; ++k) {
            out.ob_quadric[16 * oslot + k] =
                det.quadric != nullptr ? det.quadric[16 * i + k] : 0.0f;
        }
        out.ob_valid[oslot] = 1;
    }
    // the detections' surface voxels overwrite their planes' rows, in
    // detection order (V <= kThreads: a thread a key)
    if (tid < V) {
#pragma unroll
        for (int i = 0; i < kMaxDet; ++i) {
            if (i < n_det && s_pid[i] >= 0 && keys[i] >= 0) {
                out.vox[(size_t)s_pid[i] * V + tid] = keys[i];
            }
        }
    }
}

}  // namespace

// Input tables (see Tables), their outputs in separate buffers (the same
// layout, on 16-byte boundaries), the detections (see Detections;
// quadric and vox may be null); P <= 128, n_det <= 16, V <= 512.
// ``tab`` / ``out`` are arrays of the 15 table pointers in the order of
// Tables, ``dets`` of the 8 detection pointers.  One launch.
VSG_API int vsg_plane_assoc(void* const* tab, void* const* out,
                            void* const* dets, int n_det, int P, int V,
                            int Q, int kf_id, float ominus_thresh,
                            float dist_thresh, float centroid_thresh,
                            cudaStream_t stream) {
    if (P < 1 || P > kMaxP || Q < 1 || V < 0 || V > kThreads || n_det < 0 ||
        n_det > kMaxDet) {
        return (int)cudaErrorInvalidValue;
    }
    const Tables in{
        (const float*)tab[0],  (const uint8_t*)tab[1], (const float*)tab[2],
        (const float*)tab[3],  (const float*)tab[4],   (const int*)tab[5],
        (const int*)tab[6],    (const int*)tab[7],     (const int*)tab[8],
        (const int*)tab[9],    (const float*)tab[10],  (const float*)tab[11],
        (const float*)tab[12], (const uint8_t*)tab[13], (const int*)tab[14]};
    const OutTables o{
        (float*)out[0],  (uint8_t*)out[1], (float*)out[2],  (float*)out[3],
        (float*)out[4],  (int*)out[5],     (int*)out[6],    (int*)out[7],
        (int*)out[8],    (int*)out[9],     (float*)out[10], (float*)out[11],
        (float*)out[12], (uint8_t*)out[13], (int*)out[14]};
    const Detections d{(const float*)dets[0], (const uint8_t*)dets[1],
                       (const float*)dets[2], (const float*)dets[3],
                       (const float*)dets[4], (const float*)dets[5],
                       (const float*)dets[6], (const int*)dets[7]};
    // the copied tables: voxel keys (P, V) and the observation table
    const int idx[7] = {7, 8, 9, 10, 11, 12, 13};
    const int bytes[7] = {4 * P * V, 4 * Q, 4 * Q, 16 * Q, 4 * Q, 64 * Q, Q};
    CopyList cl;
    for (int t = 0; t < 7; ++t) {
        cl.src[t] = (const char*)tab[idx[t]];
        cl.dst[t] = (char*)out[idx[t]];
        cl.bytes[t] = bytes[t];
        if ((((uintptr_t)cl.src[t] | (uintptr_t)cl.dst[t]) & 15) != 0) {
            return (int)cudaErrorInvalidValue;
        }
    }
    plane_assoc_kernel<<<kCtas, kThreads, 0, stream>>>(
        in, o, d, cl, n_det, P, V, Q, kf_id, ominus_thresh, dist_thresh,
        centroid_thresh);
    return (int)cudaGetLastError();
}
