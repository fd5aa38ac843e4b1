// Device-side Lie-group helpers of the port's kernels: quaternions,
// SO(3) / Sim(3) exp and log, small dense solves and a cyclic-Jacobi
// symmetric eigensolver.
//
// The group functions are templates over the scalar: ``float`` for plain
// evaluation (K15) and ``Dual`` / ``DualD`` (a value and one directional
// derivative, in float32 / float64) for forward-mode Jacobians (K19, K20;
// K21, K22b).  They transcribe
// visual_sgraphs_tpu/core/lie.py branch for branch: every jnp.where there
// is a choice on the VALUE here, taking the derivative of the chosen
// branch, which is what jax.jacfwd computes through a where.
#pragma once

#include "common.cuh"

struct Dual {
    float v, d;
};

__device__ __forceinline__ Dual mkd(float v, float d = 0.0f) {
    Dual r;
    r.v = v;
    r.d = d;
    return r;
}
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
    return mkd(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
    return mkd(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a) { return mkd(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
    return mkd(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
    const float q = a.v / b.v;
    return mkd(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
    return mkd(a.v + b, a.d);
}
__device__ __forceinline__ Dual operator+(float a, Dual b) {
    return mkd(a + b.v, b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
    return mkd(a.v - b, a.d);
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
    return mkd(a - b.v, -b.d);
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
    return mkd(a.v * b, a.d * b);
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
    return mkd(a * b.v, a * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
    return mkd(a.v / b, a.d / b);
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
    const float q = a / b.v;
    return mkd(q, -q * b.d / b.v);
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
template <typename T>
__device__ __forceinline__ T cst(float x);
template <>
__device__ __forceinline__ float cst<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ Dual cst<Dual>(float x) {
    return mkd(x, 0.0f);
}

__device__ __forceinline__ float s_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual s_sqrt(Dual x) {
    const float r = sqrtf(x.v);
    return mkd(r, x.d * 0.5f / r);
}
__device__ __forceinline__ float s_sin(float x) { return sinf(x); }
__device__ __forceinline__ Dual s_sin(Dual x) {
    return mkd(sinf(x.v), x.d * cosf(x.v));
}
__device__ __forceinline__ float s_cos(float x) { return cosf(x); }
__device__ __forceinline__ Dual s_cos(Dual x) {
    return mkd(cosf(x.v), -x.d * sinf(x.v));
}
__device__ __forceinline__ float s_exp(float x) { return expf(x); }
__device__ __forceinline__ Dual s_exp(Dual x) {
    const float e = expf(x.v);
    return mkd(e, x.d * e);
}
__device__ __forceinline__ float s_log(float x) { return logf(x); }
__device__ __forceinline__ Dual s_log(Dual x) {
    return mkd(logf(x.v), x.d / x.v);
}
__device__ __forceinline__ float s_atan2(float y, float x) {
    return atan2f(y, x);
}
__device__ __forceinline__ Dual s_atan2(Dual y, Dual x) {
    const float r2 = x.v * x.v + y.v * y.v;
    return mkd(atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / r2);
}
// A float64 value and one directional derivative (K21, K22b: residuals
// whose float32 Jacobians lose digits, see their headers).
struct DualD {
    double v, d;
};

__device__ __forceinline__ DualD mkdd(double v, double d = 0.0) {
    DualD r;
    r.v = v;
    r.d = d;
    return r;
}
__device__ __forceinline__ DualD operator+(DualD a, DualD b) {
    return mkdd(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ DualD operator-(DualD a, DualD b) {
    return mkdd(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ DualD operator-(DualD a) {
    return mkdd(-a.v, -a.d);
}
__device__ __forceinline__ DualD operator*(DualD a, DualD b) {
    return mkdd(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ DualD operator/(DualD a, DualD b) {
    const double q = a.v / b.v;
    return mkdd(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ DualD operator+(DualD a, double b) {
    return mkdd(a.v + b, a.d);
}
__device__ __forceinline__ DualD operator+(double a, DualD b) {
    return mkdd(a + b.v, b.d);
}
__device__ __forceinline__ DualD operator-(DualD a, double b) {
    return mkdd(a.v - b, a.d);
}
__device__ __forceinline__ DualD operator-(double a, DualD b) {
    return mkdd(a - b.v, -b.d);
}
__device__ __forceinline__ DualD operator*(DualD a, double b) {
    return mkdd(a.v * b, a.d * b);
}
__device__ __forceinline__ DualD operator*(double a, DualD b) {
    return mkdd(a * b.v, a * b.d);
}
__device__ __forceinline__ DualD operator/(DualD a, double b) {
    return mkdd(a.v / b, a.d / b);
}
__device__ __forceinline__ DualD operator/(double a, DualD b) {
    const double q = a / b.v;
    return mkdd(q, -q * b.d / b.v);
}
__device__ __forceinline__ double val(DualD x) { return x.v; }
template <>
__device__ __forceinline__ DualD cst<DualD>(float x) {
    return mkdd(x);
}
__device__ __forceinline__ DualD s_sqrt(DualD x) {
    const double r = sqrt(x.v);
    return mkdd(r, x.d * 0.5 / r);
}
__device__ __forceinline__ DualD s_sin(DualD x) {
    return mkdd(sin(x.v), x.d * cos(x.v));
}
__device__ __forceinline__ DualD s_cos(DualD x) {
    return mkdd(cos(x.v), -x.d * sin(x.v));
}
__device__ __forceinline__ DualD s_exp(DualD x) {
    const double e = exp(x.v);
    return mkdd(e, x.d * e);
}
__device__ __forceinline__ DualD s_log(DualD x) {
    return mkdd(log(x.v), x.d / x.v);
}
__device__ __forceinline__ DualD s_atan2(DualD y, DualD x) {
    const double r2 = x.v * x.v + y.v * y.v;
    return mkdd(atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / r2);
}

// where(cond, a, b) with cond on values
template <typename T>
__device__ __forceinline__ T sel(bool c, T a, T b) {
    return c ? a : b;
}

constexpr float LIE_EPS2 = 1e-8f;

// _safe(x2): 1 where x2 < EPS2 (a constant: no derivative)
template <typename T>
__device__ __forceinline__ T lie_safe(T x2) {
    return val(x2) < LIE_EPS2 ? cst<T>(1.0f) : x2;
}

template <typename T>
__device__ void quat_mul(const T* q, const T* p, T* out) {
    const T w = q[0] * p[0] - q[1] * p[1] - q[2] * p[2] - q[3] * p[3];
    const T x = q[0] * p[1] + q[1] * p[0] + q[2] * p[3] - q[3] * p[2];
    const T y = q[0] * p[2] - q[1] * p[3] + q[2] * p[0] + q[3] * p[1];
    const T z = q[0] * p[3] + q[1] * p[2] - q[2] * p[1] + q[3] * p[0];
    out[0] = w;
    out[1] = x;
    out[2] = y;
    out[3] = z;
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
    const T x = a[1] * b[2] - a[2] * b[1];
    const T y = a[2] * b[0] - a[0] * b[2];
    const T z = a[0] * b[1] - a[1] * b[0];
    out[0] = x;
    out[1] = y;
    out[2] = z;
}

// v + w * uv + qvec x uv with uv = 2 qvec x v
template <typename T>
__device__ void quat_rot(const T* q, const T* v, T* out) {
    T uv[3], c[3];
    cross3(q + 1, v, uv);
    for (int i = 0; i < 3; ++i) uv[i] = 2.0f * uv[i];
    cross3(q + 1, uv, c);
    for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * uv[i] + c[i];
}

template <typename T>
__device__ void quat_normalize(T* q) {
    T n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
    if (val(n2) < 1.17549435e-38f) n2 = cst<T>(1.17549435e-38f);
    const T k = s_sqrt(1.0f / n2);
    for (int i = 0; i < 4; ++i) q[i] = q[i] * k;
}

template <typename T>
__device__ void so3_exp(const T* w, T* q) {
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = s_sqrt(lie_safe(th2));
    const T half = 0.5f * th;
    const bool small = val(th2) < LIE_EPS2;
    const T k = small ? 0.5f - th2 / 48.0f : s_sin(half) / th;
    q[0] = small ? 1.0f - th2 / 8.0f : s_cos(half);
    for (int i = 0; i < 3; ++i) q[i + 1] = k * w[i];
    quat_normalize(q);
}

template <typename T>
__device__ void so3_log(const T* qin, T* w) {
    const float sg = val(qin[0]) < 0.0f ? -1.0f : 1.0f;
    T q[4];
    for (int i = 0; i < 4; ++i) q[i] = sg * qin[i];
    T ww = q[0];
    if (val(ww) > 1.0f) ww = cst<T>(1.0f);
    if (val(ww) < -1.0f) ww = cst<T>(-1.0f);
    const T vn2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
    const T vn = s_sqrt(lie_safe(vn2));
    const bool small = val(vn2) < LIE_EPS2;
    T k;
    if (small) {
        const T wm = val(ww) < 0.5f ? cst<T>(0.5f) : ww;
        k = 2.0f / wm * (1.0f + vn2 / 6.0f);
    } else {
        k = 2.0f * s_atan2(vn, ww) / vn;
    }
    for (int i = 0; i < 3; ++i) w[i] = k * q[i + 1];
}

// W = A [w]x + B [w]x^2 + C I (the reference's _sim3_W_terms branches)
template <typename T>
__device__ void sim3_W(const T* w, T sigma, T W[3][3]) {
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T s2 = sigma * sigma;
    const T scale = s_exp(sigma);
    const bool small_s = fabsf(val(sigma)) < 1e-4f;
    const bool small_t = val(th2) < LIE_EPS2;
    const T sig_safe = small_s ? cst<T>(1.0f) : sigma;
    const T C = small_s ? 1.0f + sigma / 2.0f + s2 / 6.0f
                        : (scale - 1.0f) / sig_safe;
    T A, B;
    if (small_t) {
        A = small_s ? 0.5f + sigma / 6.0f
                    : ((sigma - 1.0f) * scale + 1.0f) / s2;
        B = small_s ? 1.0f / 6.0f + sigma / 24.0f
                    : (scale * 0.5f * s2 + scale - 1.0f - sigma * scale) /
                          (s2 * sig_safe);
    } else {
        const T th = s_sqrt(th2);
        const T c = s_cos(th), s = s_sin(th);
        if (small_s) {
            A = (1.0f - c) / th2;
            B = (th - s) / (th2 * th);
        } else {
            const T a_big = scale * s, b_big = scale * c;
            T denom = s2 + th2;
            if (val(denom) < 1e-12f) denom = cst<T>(1.0f);
            A = (a_big * sigma + (1.0f - b_big) * th) / (th * denom);
            B = (C - ((b_big - 1.0f) * sigma + a_big * th) / denom) / th2;
        }
    }
    // hat(w) and hat(w)^2
    T H[3][3] = {{cst<T>(0.0f), -w[2], w[1]},
                 {w[2], cst<T>(0.0f), -w[0]},
                 {-w[1], w[0], cst<T>(0.0f)}};
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            const T h2 = H[i][0] * H[0][j] + H[i][1] * H[1][j] +
                         H[i][2] * H[2][j];
            W[i][j] = A * H[i][j] + B * h2 + (i == j ? C : cst<T>(0.0f));
        }
    }
}

template <typename T>
__device__ void sim3_exp(const T* xi, T* S) {
    so3_exp(xi + 3, S);
    T W[3][3];
    sim3_W(xi + 3, xi[6], W);
    for (int i = 0; i < 3; ++i) {
        S[4 + i] = W[i][0] * xi[0] + W[i][1] * xi[1] + W[i][2] * xi[2];
    }
    S[7] = s_exp(xi[6]);
}

// x = A^-1 b for a 3x3 system (Gaussian elimination, partial pivoting on
// the values)
template <typename T>
__device__ void solve3(T A[3][3], T* b, T* x) {
    int perm[3] = {0, 1, 2};
    for (int c = 0; c < 3; ++c) {
        int p = c;
        for (int r = c + 1; r < 3; ++r) {
            if (fabsf(val(A[perm[r]][c])) > fabsf(val(A[perm[p]][c]))) p = r;
        }
        const int tmp = perm[c];
        perm[c] = perm[p];
        perm[p] = tmp;
        const int pc = perm[c];
        for (int r = c + 1; r < 3; ++r) {
            const int pr = perm[r];
            const T f = A[pr][c] / A[pc][c];
            for (int k = c; k < 3; ++k) A[pr][k] = A[pr][k] - f * A[pc][k];
            b[pr] = b[pr] - f * b[pc];
        }
    }
    for (int c = 2; c >= 0; --c) {
        const int pc = perm[c];
        T s = b[pc];
        for (int k = c + 1; k < 3; ++k) s = s - A[pc][k] * x[k];
        x[c] = s / A[pc][c];
    }
}

template <typename T>
__device__ void sim3_log(const T* S, T* xi) {
    so3_log(S, xi + 3);
    xi[6] = s_log(S[7]);
    T W[3][3];
    sim3_W(xi + 3, xi[6], W);
    T b[3] = {S[4], S[5], S[6]};
    solve3(W, b, xi);
}

template <typename T>
__device__ void sim3_mul(const T* A, const T* B, T* out) {
    T q[4], r[3];
    quat_mul(A, B, q);
    quat_rot(A, B + 4, r);
    for (int i = 0; i < 3; ++i) out[4 + i] = A[7] * r[i] + A[4 + i];
    out[7] = A[7] * B[7];
    for (int i = 0; i < 4; ++i) out[i] = q[i];
}

template <typename T>
__device__ void sim3_inv(const T* S, T* out) {
    T qi[4] = {S[0], -S[1], -S[2], -S[3]};
    const T si = 1.0f / S[7];
    T r[3];
    quat_rot(qi, S + 4, r);
    for (int i = 0; i < 4; ++i) out[i] = qi[i];
    for (int i = 0; i < 3; ++i) out[4 + i] = -si * r[i];
    out[7] = si;
}

template <typename T>
__device__ void sim3_apply(const T* S, const T* p, T* out) {
    T r[3];
    quat_rot(S, p, r);
    for (int i = 0; i < 3; ++i) out[i] = S[7] * r[i] + S[4 + i];
}

// Rotation matrix -> unit quaternion, largest pivot, w >= 0 (the
// reference's matrix_to_quat)
__device__ inline void matrix_to_quat(const float R[3][3], float* q) {
    const float m00 = R[0][0], m01 = R[0][1], m02 = R[0][2];
    const float m10 = R[1][0], m11 = R[1][1], m12 = R[1][2];
    const float m20 = R[2][0], m21 = R[2][1], m22 = R[2][2];
    const float tr = m00 + m11 + m22;
    const float piv[4] = {1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22};
    int b = 0;
    for (int i = 1; i < 4; ++i) {
        if (piv[i] > piv[b]) b = i;
    }
    const float c[4][4] = {
        {1 + tr, m21 - m12, m02 - m20, m10 - m01},
        {m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20},
        {m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21},
        {m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22}};
    // q_i = candidate b of component i (the reference stacks per
    // component, then picks candidate b)
    for (int i = 0; i < 4; ++i) q[i] = c[i][b];
    quat_normalize(q);
    if (q[0] < 0.0f) {
        for (int i = 0; i < 4; ++i) q[i] = -q[i];
    }
}

// Row-major 3x3 rotation of a unit quaternion (core/lie.py::quat_to_matrix).
template <typename T>
__device__ void quat_to_mat(const T* q, T* R) {
    const T w = q[0], x = q[1], y = q[2], z = q[3];
    const T xx = x * x, yy = y * y, zz = z * z;
    const T wx = w * x, wy = w * y, wz = w * z;
    const T xy = x * y, xz = x * z, yz = y * z;
    R[0] = 1.0f - 2.0f * (yy + zz);
    R[1] = 2.0f * (xy - wz);
    R[2] = 2.0f * (xz + wy);
    R[3] = 2.0f * (xy + wz);
    R[4] = 1.0f - 2.0f * (xx + zz);
    R[5] = 2.0f * (yz - wx);
    R[6] = 2.0f * (xz - wy);
    R[7] = 2.0f * (yz + wx);
    R[8] = 1.0f - 2.0f * (xx + yy);
}

// Row-major 3x3 product C = A B (C must not alias A or B).
template <typename T>
__device__ void mat3_mul(const T* A, const T* B, T* C) {
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                           A[3 * i + 2] * B[6 + j];
        }
    }
}

// Left Jacobian V = I + a [w]x + b [w]x^2 of SO(3) with the reference's
// branches, including its guard on theta^2 * theta (not theta^3 alone):
// for 1e-4 <= theta < ~2.2e-3 the reference divides by 1, and so does
// this (core/lie.py::_so3_left_jacobian_terms).
template <typename T>
__device__ void so3_left_jac(const T* w, T* J) {
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = s_sqrt(lie_safe(th2));
    const bool small = val(th2) < LIE_EPS2;
    const T a = small ? 0.5f - th2 / 24.0f : (1.0f - s_cos(th)) / lie_safe(th2);
    const T b = small ? 1.0f / 6.0f - th2 / 120.0f
                      : (th - s_sin(th)) / lie_safe(th2 * th);
    const T W[9] = {cst<T>(0.0f), -w[2], w[1], w[2], cst<T>(0.0f), -w[0],
                    -w[1], w[0], cst<T>(0.0f)};
    T WW[9];
    mat3_mul(W, W, WW);
    for (int i = 0; i < 9; ++i) {
        J[i] = (i % 4 == 0 ? cst<T>(1.0f) : cst<T>(0.0f)) + a * W[i] +
               b * WW[i];
    }
}

// Inverse left Jacobian I - W / 2 + c W^2 (core/lie.py).
template <typename T>
__device__ void so3_left_jac_inv(const T* w, T* J) {
    const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const T th = s_sqrt(lie_safe(th2));
    const bool small = val(th2) < LIE_EPS2;
    const T half = 0.5f * th;
    const T cot_term =
        half * s_cos(half) / (small ? cst<T>(1.0f) : s_sin(half));
    const T c = small ? 1.0f / 12.0f + th2 / 720.0f
                      : (1.0f - cot_term) / lie_safe(th2);
    const T W[9] = {cst<T>(0.0f), -w[2], w[1], w[2], cst<T>(0.0f), -w[0],
                    -w[1], w[0], cst<T>(0.0f)};
    T WW[9];
    mat3_mul(W, W, WW);
    for (int i = 0; i < 9; ++i) {
        J[i] = (i % 4 == 0 ? cst<T>(1.0f) : cst<T>(0.0f)) - 0.5f * W[i] +
               c * WW[i];
    }
}

// SE(3) as [qw qx qy qz tx ty tz]; tangent [rho, omega].
template <typename T>
__device__ void se3_mul(const T* A, const T* B, T* out) {
    T q[4], r[3];
    quat_mul(A, B, q);
    quat_rot(A, B + 4, r);
    for (int i = 0; i < 4; ++i) out[i] = q[i];
    for (int i = 0; i < 3; ++i) out[4 + i] = r[i] + A[4 + i];
}

template <typename T>
__device__ void se3_inv(const T* Tin, T* out) {
    const T qi[4] = {Tin[0], -Tin[1], -Tin[2], -Tin[3]};
    T r[3];
    quat_rot(qi, Tin + 4, r);
    for (int i = 0; i < 4; ++i) out[i] = qi[i];
    for (int i = 0; i < 3; ++i) out[4 + i] = -r[i];
}

template <typename T>
__device__ void se3_exp(const T* xi, T* out) {
    so3_exp(xi + 3, out);
    T V[9];
    so3_left_jac(xi + 3, V);
    for (int i = 0; i < 3; ++i) {
        out[4 + i] = V[3 * i] * xi[0] + V[3 * i + 1] * xi[1] +
                     V[3 * i + 2] * xi[2];
    }
}

template <typename T>
__device__ void se3_log(const T* Tin, T* xi) {
    so3_log(Tin, xi + 3);
    T Vi[9];
    so3_left_jac_inv(xi + 3, Vi);
    for (int i = 0; i < 3; ++i) {
        xi[i] = Vi[3 * i] * Tin[4] + Vi[3 * i + 1] * Tin[5] +
                Vi[3 * i + 2] * Tin[6];
    }
}

// Rotation matrix (row-major) -> unit quaternion, largest pivot on the
// values, w >= 0 (core/lie.py::matrix_to_quat), for float and Dual.
template <typename T>
__device__ void mat_to_quat(const T* R, T* q) {
    const T tr = R[0] + R[4] + R[8];
    const T piv[4] = {1.0f + tr, 1.0f + R[0] - R[4] - R[8],
                      1.0f - R[0] + R[4] - R[8], 1.0f - R[0] - R[4] + R[8]};
    int b = 0;
    for (int i = 1; i < 4; ++i) {
        if (val(piv[i]) > val(piv[b])) b = i;
    }
    const T c[4][4] = {
        {1.0f + tr, R[7] - R[5], R[2] - R[6], R[3] - R[1]},
        {R[7] - R[5], 1.0f + R[0] - R[4] - R[8], R[1] + R[3], R[2] + R[6]},
        {R[2] - R[6], R[1] + R[3], 1.0f - R[0] + R[4] - R[8], R[5] + R[7]},
        {R[3] - R[1], R[2] + R[6], R[5] + R[7], 1.0f - R[0] - R[4] + R[8]}};
    for (int i = 0; i < 4; ++i) q[i] = c[i][b];
    quat_normalize(q);
    if (val(q[0]) < 0.0f) {
        for (int i = 0; i < 4; ++i) q[i] = -q[i];
    }
}

// Symmetric N x N eigen-decomposition by cyclic Jacobi (double, in place
// in one thread).  On return the diagonal of ``a`` holds the eigenvalues
// and the columns of ``v`` the eigenvectors.
template <int N>
__device__ void jacobi_eigen(double (&a)[N][N], double (&v)[N][N]) {
    for (int i = 0; i < N; ++i) {
        for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0 : 0.0;
    }
    for (int sweep = 0; sweep < 50; ++sweep) {
        double off = 0.0, diag = 0.0;
        for (int i = 0; i < N; ++i) {
            diag += fabs(a[i][i]);
            for (int j = i + 1; j < N; ++j) off += fabs(a[i][j]);
        }
        if (off <= 1e-15 * diag || off == 0.0) break;
        for (int p = 0; p < N - 1; ++p) {
            for (int q = p + 1; q < N; ++q) {
                const double apq = a[p][q];
                if (apq == 0.0) continue;
                const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
                const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                                 (fabs(theta) + sqrt(theta * theta + 1.0));
                const double c = 1.0 / sqrt(t * t + 1.0);
                const double s = t * c;
                for (int k = 0; k < N; ++k) {
                    const double akp = a[k][p], akq = a[k][q];
                    a[k][p] = c * akp - s * akq;
                    a[k][q] = s * akp + c * akq;
                }
                for (int k = 0; k < N; ++k) {
                    const double apk = a[p][k], aqk = a[q][k];
                    a[p][k] = c * apk - s * aqk;
                    a[q][k] = s * apk + c * aqk;
                }
                for (int k = 0; k < N; ++k) {
                    const double vkp = v[k][p], vkq = v[k][q];
                    v[k][p] = c * vkp - s * vkq;
                    v[k][q] = s * vkp + c * vkq;
                }
            }
        }
    }
}

// The rotation of an orthogonal-Procrustes / Horn problem from a 3x3
// matrix M with SVD U S V^T: R = U diag(1, 1, det(U V^T)) V^T, written as
// u1 v1^T + u2 v2^T + det(V) (u1 x u2) v3^T (independent of the sign the
// SVD gives u3), and the singular values (descending).  Rank-deficient M
// completes u2 by an orthogonal unit vector; M = 0 gives R = I.
__device__ inline void procrustes(const float M[3][3], float R[3][3],
                                  float sv[3]) {
    double a[3][3], v[3][3];
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            double s = 0.0;
            for (int k = 0; k < 3; ++k) s += (double)M[k][i] * M[k][j];
            a[i][j] = s;
        }
    }
    jacobi_eigen<3>(a, v);
    int o[3] = {0, 1, 2};  // descending eigenvalues
    for (int i = 0; i < 3; ++i) {
        for (int j = i + 1; j < 3; ++j) {
            if (a[o[j]][o[j]] > a[o[i]][o[i]]) {
                const int t = o[i];
                o[i] = o[j];
                o[j] = t;
            }
        }
    }
    double V[3][3];
    for (int c = 0; c < 3; ++c) {
        sv[c] = (float)sqrt(fmax(a[o[c]][o[c]], 0.0));
        for (int r = 0; r < 3; ++r) V[r][c] = v[r][o[c]];
    }
    if (!(sv[0] > 1e-30f)) {
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) R[i][j] = i == j ? 1.0f : 0.0f;
        }
        return;
    }
    double u[2][3];
    for (int c = 0; c < 2; ++c) {
        double n = 0.0;
        for (int r = 0; r < 3; ++r) {
            double s = 0.0;
            for (int k = 0; k < 3; ++k) s += (double)M[r][k] * V[k][c];
            u[c][r] = s;
            n += s * s;
        }
        n = sqrt(n);
        if (c == 1 && !(n > 1e-9 * sv[0])) {
            // complete u2 orthogonally to u1
            const double ax = fabs(u[0][0]) < 0.6 ? 1.0 : 0.0;
            const double ay = ax == 0.0 ? 1.0 : 0.0;
            double w[3] = {ax, ay, 0.0};
            const double d = w[0] * u[0][0] + w[1] * u[0][1];
            for (int r = 0; r < 3; ++r) w[r] -= d * u[0][r];
            n = sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
            for (int r = 0; r < 3; ++r) u[1][r] = w[r];
        }
        for (int r = 0; r < 3; ++r) u[c][r] /= n;
    }
    const double u3[3] = {u[0][1] * u[1][2] - u[0][2] * u[1][1],
                          u[0][2] * u[1][0] - u[0][0] * u[1][2],
                          u[0][0] * u[1][1] - u[0][1] * u[1][0]};
    const double detV = V[0][0] * (V[1][1] * V[2][2] - V[1][2] * V[2][1]) -
                        V[0][1] * (V[1][0] * V[2][2] - V[1][2] * V[2][0]) +
                        V[0][2] * (V[1][0] * V[2][1] - V[1][1] * V[2][0]);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            R[i][j] = (float)(u[0][i] * V[j][0] + u[1][i] * V[j][1] +
                              detV * u3[i] * V[j][2]);
        }
    }
}

// x = A^-1 b for an N x N system (double, partial pivoting; A, b
// overwritten)
template <int N>
__device__ void solve_dense(double (&A)[N][N], double (&b)[N],
                            double (&x)[N]) {
    for (int c = 0; c < N; ++c) {
        int p = c;
        for (int r = c + 1; r < N; ++r) {
            if (fabs(A[r][c]) > fabs(A[p][c])) p = r;
        }
        if (p != c) {
            for (int k = 0; k < N; ++k) {
                const double t = A[c][k];
                A[c][k] = A[p][k];
                A[p][k] = t;
            }
            const double t = b[c];
            b[c] = b[p];
            b[p] = t;
        }
        for (int r = c + 1; r < N; ++r) {
            const double f = A[r][c] / A[c][c];
            for (int k = c; k < N; ++k) A[r][k] -= f * A[c][k];
            b[r] -= f * b[c];
        }
    }
    for (int c = N - 1; c >= 0; --c) {
        double s = b[c];
        for (int k = c + 1; k < N; ++k) s -= A[c][k] * x[k];
        x[c] = s / A[c][c];
    }
}
