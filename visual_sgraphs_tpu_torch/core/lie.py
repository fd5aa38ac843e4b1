"""SO(3) / SE(3) / Sim(3) Lie-group operations on torch tensors.

Port of ``visual_sgraphs_tpu/core/lie.py`` (the subset the RGB-D tracking
and local-mapping path calls).  Representations are unchanged:

- SO(3): unit quaternion ``[w, x, y, z]`` (shape ``(..., 4)``).
- SE(3): ``[qw, qx, qy, qz, tx, ty, tz]`` (shape ``(..., 7)``).
- Sim(3): ``[qw, qx, qy, qz, tx, ty, tz, s]`` (shape ``(..., 8)``).

The se3 tangent is ``[rho(3), omega(3)]`` with ``exp([rho, omega]) =
(exp(omega), V(omega) @ rho)``.  Every function broadcasts over leading
batch dimensions; small-angle branches are ``torch.where`` over Taylor
expansions, as in the reference, so no function reads a value back to the
host.
"""

from __future__ import annotations

import torch

# Small-angle crossover (the reference's _EPS2).
_EPS2 = 1e-8


def _safe(x2):
    return torch.where(x2 < _EPS2, torch.ones_like(x2), x2)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# quaternion primitives ([w, x, y, z], Hamilton convention)
# ---------------------------------------------------------------------------


def quat_multiply(q, p):
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.sqrt(1.0 / torch.clamp(n2, min=torch.finfo(q.dtype).tiny))


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q."""
    qvec = q[..., 1:]
    uv = 2.0 * _cross(qvec, v)
    return v + q[..., :1] * uv + _cross(qvec, uv)


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix -> unit quaternion, branch-free (largest pivot)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     dim=-1)
    pivots = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                          1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 cands, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def hat(v):
    """Skew-symmetric matrix of (..., 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def so3_exp(omega):
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(_safe(theta2))
    half = 0.5 * theta
    small = theta2 < _EPS2
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * omega], dim=-1))


def so3_log(q):
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:] * q[..., 1:], dim=-1, keepdim=True)
    vn = torch.sqrt(_safe(vn2))
    theta = 2.0 * torch.atan2(vn, w)
    small = vn2 < _EPS2
    k = torch.where(small, 2.0 / torch.clamp(w, min=0.5) * (1.0 + vn2 / 6.0),
                    theta / vn)
    return k * q[..., 1:]


def so3_left_jacobian(omega):
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(_safe(theta2))
    small = theta2 < _EPS2
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / _safe(theta2))
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / _safe(theta2 * theta))
    W = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(W)
    return eye + a[..., None] * W + b[..., None] * (W @ W)


def so3_left_jacobian_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(_safe(theta2))
    small = theta2 < _EPS2
    half = 0.5 * theta
    cot_term = half * torch.cos(half) / torch.where(
        small, torch.ones_like(half), torch.sin(half))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - cot_term) / _safe(theta2))
    W = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(W)
    return eye - 0.5 * W + c[..., None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3)  —  [qw qx qy qz tx ty tz]
# ---------------------------------------------------------------------------


def se3_identity(dtype=torch.float32, device=None):
    # built on the device: a tensor made from a host list is a synchronising
    # host-to-device copy
    return torch.cat([torch.ones((1,), dtype=dtype, device=device),
                      torch.zeros((6,), dtype=dtype, device=device)])


def se3_from_rt(q, t):
    return torch.cat([q, t], dim=-1)


def se3_multiply(A, B):
    q = quat_multiply(A[..., :4], B[..., :4])
    t = quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    return se3_from_rt(q, t)


def se3_inverse(T):
    qinv = quat_conjugate(T[..., :4])
    return se3_from_rt(qinv, -quat_rotate(qinv, T[..., 4:7]))


def se3_apply(T, p):
    """Transform point(s) p (..., 3) by T (..., 7)."""
    return quat_rotate(T[..., :4], p) + T[..., 4:7]


def se3_exp(xi):
    rho, omega = xi[..., :3], xi[..., 3:6]
    q = so3_exp(omega)
    V = so3_left_jacobian(omega)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return se3_from_rt(q, t)


def se3_log(T):
    omega = so3_log(T[..., :4])
    Vinv = so3_left_jacobian_inv(omega)
    rho = torch.einsum("...ij,...j->...i", Vinv, T[..., 4:7])
    return torch.cat([rho, omega], dim=-1)


def se3_boxplus(T, xi):
    """Left-multiplicative update exp(xi) * T."""
    return se3_multiply(se3_exp(xi), T)


def se3_normalize(T):
    return se3_from_rt(quat_normalize(T[..., :4]), T[..., 4:7])


# ---------------------------------------------------------------------------
# Sim(3)  —  [qw qx qy qz tx ty tz s]; tangent [rho(3), omega(3), sigma(1)]
# with s = exp(sigma)
# ---------------------------------------------------------------------------


def sim3_identity(dtype=torch.float32, device=None):
    return torch.cat([torch.ones((1,), dtype=dtype, device=device),
                      torch.zeros((6,), dtype=dtype, device=device),
                      torch.ones((1,), dtype=dtype, device=device)])


def sim3_multiply(A, B):
    q = quat_multiply(A[..., :4], B[..., :4])
    t = A[..., 7:8] * quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    s = A[..., 7:8] * B[..., 7:8]
    return torch.cat([q, t, s], dim=-1)


def sim3_inverse(S):
    qinv = quat_conjugate(S[..., :4])
    sinv = 1.0 / S[..., 7:8]
    t = -sinv * quat_rotate(qinv, S[..., 4:7])
    return torch.cat([qinv, t, sinv], dim=-1)


def sim3_apply(S, p):
    return S[..., 7:8] * quat_rotate(S[..., :4], p) + S[..., 4:7]


def sim3_from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-1] + (1,), dtype=T.dtype, device=T.device)
    return torch.cat([T, s.expand(T.shape[:-1] + (1,))], dim=-1)


def sim3_to_se3(S):
    """Drop the scale (the caller decides what it means)."""
    return S[..., :7]


def _sim3_W_terms(omega, sigma):
    """Coefficients (A, B, C) with W = A [w]x + B [w]x^2 + C I (Sophus Sim3
    exp), with the reference's small-angle / small-scale branches."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    s2 = sigma * sigma
    scale = torch.exp(sigma)
    small_s = torch.abs(sigma) < 1e-4
    small_t = theta2 < _EPS2
    one_s = torch.ones_like(sigma)
    sig_safe = torch.where(small_s, one_s, sigma)
    C = torch.where(small_s, 1.0 + sigma / 2.0 + s2 / 6.0,
                    (scale - 1.0) / sig_safe)
    th_safe = torch.sqrt(_safe(theta2))
    cos_t, sin_t = torch.cos(th_safe), torch.sin(th_safe)
    a_big = scale * sin_t
    b_big = scale * cos_t
    denom = s2 + theta2
    denom = torch.where(denom < 1e-12, torch.ones_like(denom), denom)
    A_gen = (a_big * sigma + (1.0 - b_big) * th_safe) / (th_safe * denom)
    B_gen = (C - ((b_big - 1.0) * sigma + a_big * th_safe) / denom) \
        / _safe(theta2)
    A_s0 = (1.0 - cos_t) / _safe(theta2)
    B_s0 = (th_safe - sin_t) / _safe(theta2 * th_safe)
    s2_safe = torch.where(small_s, torch.ones_like(s2), s2)
    A_t0 = torch.where(small_s, 0.5 + sigma / 6.0,
                       ((sigma - 1.0) * scale + 1.0) / s2_safe)
    B_t0 = torch.where(small_s, 1.0 / 6.0 + sigma / 24.0,
                       (scale * 0.5 * s2 + scale - 1.0 - sigma * scale)
                       / torch.where(small_s, torch.ones_like(s2),
                                     s2 * sig_safe))
    A = torch.where(small_t, A_t0, torch.where(small_s, A_s0, A_gen))
    B = torch.where(small_t, B_t0, torch.where(small_s, B_s0, B_gen))
    return A, B, C


def _sim3_W(omega, sigma):
    A, B, C = _sim3_W_terms(omega, sigma)
    W_ = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(W_)
    return A[..., None] * W_ + B[..., None] * (W_ @ W_) + C[..., None] * eye


def sim3_exp(xi):
    """Tangent [rho(3), omega(3), sigma(1)] -> Sim3."""
    rho, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    q = so3_exp(omega)
    t = torch.einsum("...ij,...j->...i", _sim3_W(omega, sigma), rho)
    return torch.cat([q, t, torch.exp(sigma)], dim=-1)


def _solve3(M, b):
    """M^-1 b for (..., 3, 3) M by the adjugate: elementary operations
    only, so forward-mode AD under ``torch.func.vmap`` stays exact (the
    batched forward derivative of ``torch.linalg.solve`` there is not)."""
    c0 = _cross(M[..., 1, :], M[..., 2, :])
    c1 = _cross(M[..., 2, :], M[..., 0, :])
    c2 = _cross(M[..., 0, :], M[..., 1, :])
    det = torch.sum(M[..., 0, :] * c0, dim=-1, keepdim=True)
    adj_b = c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]
    return adj_b / det


def sim3_log(S):
    omega = so3_log(S[..., :4])
    sigma = torch.log(S[..., 7:8])
    rho = _solve3(_sim3_W(omega, sigma), S[..., 4:7])
    return torch.cat([rho, omega, sigma], dim=-1)


def sim3_boxplus(S, xi):
    return sim3_multiply(sim3_exp(xi), S)


def sim3_normalize(S):
    return torch.cat([quat_normalize(S[..., :4]), S[..., 4:7],
                      torch.abs(S[..., 7:8])], dim=-1)
