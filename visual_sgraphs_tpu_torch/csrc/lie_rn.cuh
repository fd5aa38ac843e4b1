// Pose algebra rounded op for op as the port's plain torch chain does on
// the card (core/lie.py), shared by K25 (scan_epilogue.cu), K27
// (kf_insert.cu) and K29 (map_cull.cu).
//
// Every product and sum is a separately rounded __fmul_rn / __fadd_rn,
// so nvcc contracts nothing into an FMA (it would otherwise contract
// a*b - c*d), and the cross product rounds as torch.linalg.cross does on
// the card: one FMA over the rounded second product.  The results are
// then bitwise those of the torch chain on the card.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}

// core/lie.py::quat_multiply, rounded term by term left to right
__device__ void quat_mul_rn(const float* q, const float* p, float* o) {
    o[0] = sub(sub(sub(mul(q[0], p[0]), mul(q[1], p[1])), mul(q[2], p[2])),
               mul(q[3], p[3]));
    o[1] = sub(add(add(mul(q[0], p[1]), mul(q[1], p[0])), mul(q[2], p[3])),
               mul(q[3], p[2]));
    o[2] = add(add(sub(mul(q[0], p[2]), mul(q[1], p[3])), mul(q[2], p[0])),
               mul(q[3], p[1]));
    o[3] = add(sub(add(mul(q[0], p[3]), mul(q[1], p[2])), mul(q[2], p[1])),
               mul(q[3], p[0]));
}

// torch.linalg.cross's rounding on the card (one FMA over the rounded
// second product)
__device__ __forceinline__ void cross_rn(const float* a, const float* b,
                                         float* c) {
    c[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
    c[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
    c[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// core/lie.py::quat_rotate: v + w uv + qvec x uv, uv = 2 qvec x v
__device__ void quat_rot_rn(const float* q, const float* v, float* o) {
    float uv[3], c[3];
    cross_rn(q + 1, v, uv);
    for (int i = 0; i < 3; ++i) uv[i] = mul(2.0f, uv[i]);
    cross_rn(q + 1, uv, c);
    for (int i = 0; i < 3; ++i) o[i] = add(add(v[i], mul(q[0], uv[i])), c[i]);
}

// core/lie.py::se3_multiply
__device__ void se3_mul_rn(const float* A, const float* B, float* o) {
    float q[4], r[3];
    quat_mul_rn(A, B, q);
    quat_rot_rn(A, B + 4, r);
    for (int i = 0; i < 4; ++i) o[i] = q[i];
    for (int i = 0; i < 3; ++i) o[4 + i] = add(r[i], A[4 + i]);
}

// core/lie.py::se3_inverse
__device__ void se3_inv_rn(const float* T, float* o) {
    const float qi[4] = {T[0], -T[1], -T[2], -T[3]};
    float r[3];
    quat_rot_rn(qi, T + 4, r);
    for (int i = 0; i < 4; ++i) o[i] = qi[i];
    for (int i = 0; i < 3; ++i) o[4 + i] = -r[i];
}

// core/lie.py::se3_normalize: q sqrt(1 / max(|q|^2, tiny)), in place
__device__ void se3_normalize_rn(float* T) {
    float n2 = mul(T[0], T[0]);
    for (int i = 1; i < 4; ++i) n2 = add(n2, mul(T[i], T[i]));
    const float k =
        __fsqrt_rn(__fdiv_rn(1.0f, fmaxf(n2, 1.17549435e-38f)));
    for (int i = 0; i < 4; ++i) T[i] = mul(T[i], k);
}

// normalize(A B^-1)
__device__ void mul_inv_normalize(const float* A, const float* B, float* o) {
    float Bi[7];
    se3_inv_rn(B, Bi);
    se3_mul_rn(A, Bi, o);
    se3_normalize_rn(o);
}

// normalize(A B)
__device__ void mul_normalize(const float* A, const float* B, float* o) {
    se3_mul_rn(A, B, o);
    se3_normalize_rn(o);
}

// A keypoint's world point (core/cameras.py::unproject_pinhole scaled by
// its depth, then se3_apply of T_wc = se3_inverse(T_cw)): ((u - cx) / fx
// d, (v - cy) / fy d, d) rotated by T_wc's quaternion, plus its
// translation; cam = [fx, fy, cx, cy]
__device__ void backproject_rn(const float* cam, float u, float v, float d,
                               const float* T_wc, float* o) {
    const float p[3] = {mul(__fdiv_rn(sub(u, cam[2]), cam[0]), d),
                        mul(__fdiv_rn(sub(v, cam[3]), cam[1]), d), d};
    float r[3];
    quat_rot_rn(T_wc, p, r);
    for (int i = 0; i < 3; ++i) o[i] = add(r[i], T_wc[4 + i]);
}

}  // namespace
