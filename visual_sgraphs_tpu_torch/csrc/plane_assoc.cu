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
// runs ~60 dependent small operations a detection.  Design: one block of
// 512 threads, one launch a keyframe.  The block first copies the voxel
// and observation tables to the outputs and the plane table into shared
// memory; then, per detection, a thread per plane computes its score, a
// block-wide arg-min (``vsg_block_arg_best``: the first minimum, as
// jnp.argmin) selects the match, thread 0 applies the update, allocation
// and observation record, and the threads merge the voxel row, one key
// each.  The chart uses atan2f / sinf / cosf, which differ from the CPU's
// libm in the last ulps, so coefficients and centroids agree within 1e-5;
// every integer field is exact unless a score lies within an ulp of a
// threshold or of another plane's.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxP = 128;
constexpr int kWarps = kThreads / 32;

// R = Rz(azimuth) Ry(-elevation) of normal v, row-major (plane3d.h:64-71)
__device__ void normal_rotation(const float* v, float* R) {
    const float az = atan2f(v[1], v[0]);
    const float el = atan2f(v[2], sqrtf(v[0] * v[0] + v[1] * v[1]));
    const float ca = cosf(az), sa = sinf(az), ce = cosf(el), se = sinf(el);
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

// Chart coordinates of plane ``other`` relative to plane ``ref``
__device__ void ominus(const float* ref, const float* other, float* out) {
    float R[9];
    normal_rotation(ref, R);
    float n[3];
    for (int k = 0; k < 3; ++k) {
        n[k] = R[k] * other[0] + R[3 + k] * other[1] + R[6 + k] * other[2];
    }
    out[0] = atan2f(n[1], n[0]);
    out[1] = atan2f(n[2], sqrtf(n[0] * n[0] + n[1] * n[1]));
    out[2] = -other[3] - -ref[3];
}

// The plane ``coeffs`` moved by the chart perturbation ``delta``,
// normalised (plane3d.h:73-89)
__device__ void oplus(const float* coeffs, const float* delta, float* out) {
    const float c = cosf(delta[1]), s = sinf(delta[1]);
    const float nl[3] = {c * cosf(delta[0]), c * sinf(delta[0]), s};
    float R[9];
    normal_rotation(coeffs, R);
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

template <typename T>
__device__ void copy_rows(const T* __restrict__ src, T* __restrict__ dst,
                          int n) {
    for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

__global__ void __launch_bounds__(kThreads)
plane_assoc_kernel(Tables in, OutTables out, Detections det, int n_det,
                   int P, int V, int Q, int kf_id, float ominus_thresh,
                   float dist_thresh, float centroid_thresh) {
    __shared__ float s_coeffs[kMaxP][4], s_cen[kMaxP][3], s_npts[kMaxP],
        s_votes[kMaxP][3];
    __shared__ int s_nobs[kMaxP];
    __shared__ uint8_t s_valid[kMaxP];
    __shared__ int s_n_planes, s_n_obs, s_plane_id;
    __shared__ float red_v[kWarps];
    __shared__ int red_i[kWarps];
    const int tid = threadIdx.x;
    for (int p = tid; p < P; p += kThreads) {
        for (int k = 0; k < 4; ++k) s_coeffs[p][k] = in.coeffs[4 * p + k];
        for (int k = 0; k < 3; ++k) {
            s_cen[p][k] = in.centroid[3 * p + k];
            s_votes[p][k] = in.votes[3 * p + k];
        }
        s_npts[p] = in.npts[p];
        s_nobs[p] = in.nobs[p];
        s_valid[p] = in.valid[p];
    }
    if (tid == 0) {
        s_n_planes = *in.n_planes;
        s_n_obs = *in.n_obs;
    }
    copy_rows(in.vox, out.vox, P * V);
    copy_rows(in.ob_kf, out.ob_kf, Q);
    copy_rows(in.ob_plane, out.ob_plane, Q);
    copy_rows(in.ob_coeffs, out.ob_coeffs, 4 * Q);
    copy_rows(in.ob_conf, out.ob_conf, Q);
    copy_rows(in.ob_quadric, out.ob_quadric, 16 * Q);
    copy_rows(in.ob_valid, out.ob_valid, Q);
    __syncthreads();
    for (int i = 0; i < n_det; ++i) {
        const float* coeffs = det.coeffs + 4 * i;
        const float* dc = det.centroid + 3 * i;
        const bool ok = det.valid[i];
        float v = INFINITY;
        int b = INT_MAX;
        for (int p = tid; p < P; p += kThreads) {
            float om[3];
            ominus(s_coeffs[p], coeffs, om);
            const float ang = sqrtf(om[0] * om[0] + om[1] * om[1]);
            const float dd = fabsf(om[2]);
            const float dx = s_cen[p][0] - dc[0], dy = s_cen[p][1] - dc[1],
                        dz = s_cen[p][2] - dc[2];
            const float cdist = sqrtf(dx * dx + dy * dy + dz * dz);
            const bool cand = s_valid[p] && ang < ominus_thresh
                              && dd < dist_thresh && cdist < centroid_thresh;
            const float score = cand ? ang + dd : INFINITY;
            if (vsg_better<false>(score, p, v, b)) {
                v = score;
                b = p;
            }
        }
        vsg_block_arg_best<false>(v, b, red_v, red_i);
        if (tid == 0) {
            const bool matched = ok && isfinite(v);
            const float npts = det.npts[i];
            if (matched) {
                // running weighted average in the chart of the old plane
                const float w_old = fmaxf(s_npts[b], 1.0f);
                const float w_new = fmaxf(npts, 1.0f);
                const float alpha = w_new / (w_old + w_new);
                float om[3], blended[4];
                ominus(s_coeffs[b], coeffs, om);
                for (int k = 0; k < 3; ++k) om[k] = alpha * om[k];
                oplus(s_coeffs[b], om, blended);
                for (int k = 0; k < 4; ++k) s_coeffs[b][k] = blended[k];
                for (int k = 0; k < 3; ++k) {
                    s_cen[b][k] = s_cen[b][k] * (1.0f - alpha) + dc[k] * alpha;
                    s_votes[b][k] += det.votes[3 * i + k];
                }
                s_npts[b] += npts;
                s_nobs[b] += 1;
            }
            const int n_pl = s_n_planes;
            const int slot = min(n_pl, P - 1);
            const bool alloc = ok && !matched && n_pl < P;
            if (alloc) {
                for (int k = 0; k < 4; ++k) s_coeffs[slot][k] = coeffs[k];
                for (int k = 0; k < 3; ++k) {
                    s_cen[slot][k] = dc[k];
                    s_votes[slot][k] += det.votes[3 * i + k];
                }
                s_valid[slot] = 1;
                s_npts[slot] += npts;
                s_nobs[slot] += 1;
                s_n_planes = n_pl + 1;
            }
            const int plane_id = matched ? b : alloc ? slot : -1;
            s_plane_id = plane_id;
            const int n_ob = s_n_obs;
            const int oslot = min(n_ob, Q - 1);
            if (plane_id >= 0 && n_ob < Q) {
                const float* vt = det.votes + 3 * i;
                out.ob_kf[oslot] = kf_id;
                out.ob_plane[oslot] = plane_id;
                for (int k = 0; k < 4; ++k) {
                    out.ob_coeffs[4 * oslot + k] = det.local[4 * i + k];
                }
                out.ob_conf[oslot] =
                    (vt[0] + vt[1] + vt[2]) / fmaxf(npts, 1.0f);
                for (int k = 0; k < 16; ++k) {
                    out.ob_quadric[16 * oslot + k] =
                        det.quadric != nullptr ? det.quadric[16 * i + k] : 0.0f;
                }
                out.ob_valid[oslot] = 1;
                s_n_obs = n_ob + 1;
            }
        }
        __syncthreads();
        // the detection's surface voxels overwrite the plane's row
        const int plane_id = s_plane_id;
        if (det.vox != nullptr && plane_id >= 0) {
            for (int k = tid; k < V; k += kThreads) {
                const int key = det.vox[(size_t)i * V + k];
                if (key >= 0) out.vox[(size_t)plane_id * V + k] = key;
            }
        }
        __syncthreads();
    }
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
}

}  // namespace

// Input tables (see Tables), their outputs in separate buffers (the same
// layout), the detections (see Detections; quadric and vox may be null);
// P <= 128.  ``tab`` / ``out`` are arrays of the 15 table pointers in the
// order of Tables, ``dets`` of the 8 detection pointers.
VSG_API int vsg_plane_assoc(void* const* tab, void* const* out,
                            void* const* dets, int n_det, int P, int V,
                            int Q, int kf_id, float ominus_thresh,
                            float dist_thresh, float centroid_thresh,
                            cudaStream_t stream) {
    if (P < 1 || P > kMaxP || Q < 1 || V < 0 || n_det < 0) {
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
    plane_assoc_kernel<<<1, kThreads, 0, stream>>>(
        in, o, d, n_det, P, V, Q, kf_id, ominus_thresh, dist_thresh,
        centroid_thresh);
    return (int)cudaGetLastError();
}
