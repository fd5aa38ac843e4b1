"""Minimal-chart 3D plane parameterization (azimuth/elevation/distance).

Port of ``visual_sgraphs_tpu/core/plane.py`` (g2o ``Plane3D`` behaviour):
a plane is ``coeffs = [nx, ny, nz, c]`` with ``|n| = 1`` and signed
distance ``d = -c`` (a point on the plane satisfies ``n·x + c = 0``).  The
3-dof chart is ``(azimuth, elevation, distance)`` of the normal expressed
in the frame of a reference plane.  Every function broadcasts over leading
dimensions and works under ``torch.func`` transforms.
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import lie


def normalize(coeffs):
    """Scale so the normal part has unit length (sign preserved)."""
    n = torch.linalg.norm(coeffs[..., :3], dim=-1, keepdim=True)
    return coeffs / torch.clamp(n, min=torch.finfo(coeffs.dtype).tiny)


def plane_normal(coeffs):
    return coeffs[..., :3]


def plane_distance(coeffs):
    return -coeffs[..., 3]


def azimuth(v):
    return torch.atan2(v[..., 1], v[..., 0])


def elevation(v):
    return torch.atan2(v[..., 2], torch.linalg.norm(v[..., :2], dim=-1))


def normal_rotation(v):
    """Rotation R = Rz(azimuth) @ Ry(-elevation) mapping +x to v/|v|
    (plane3d.h:64-71)."""
    az, el = azimuth(v), elevation(v)
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se = torch.cos(el), torch.sin(el)
    m = torch.stack([
        ca * ce, -sa, -ca * se,
        sa * ce, ca, -sa * se,
        se, torch.zeros_like(az), ce,
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def oplus(coeffs, delta):
    """Apply the chart perturbation ``delta = (d_az, d_el, d_dist)``
    (plane3d.h:73-89)."""
    d_az, d_el, d_d = delta[..., 0], delta[..., 1], delta[..., 2]
    c, s = torch.cos(d_el), torch.sin(d_el)
    n_local = torch.stack([c * torch.cos(d_az), c * torch.sin(d_az), s],
                          dim=-1)
    R = normal_rotation(plane_normal(coeffs))
    n_new = torch.einsum("...ij,...j->...i", R, n_local)
    d_new = plane_distance(coeffs) + d_d
    return normalize(torch.cat([n_new, -d_new[..., None]], dim=-1))


def ominus(ref, other):
    """Chart coordinates of ``other`` relative to ``ref``: the exact
    inverse of ``oplus`` (the reference flips g2o's distance sign so that
    ``ominus(p, oplus(p, delta)) == delta``)."""
    R_T = normal_rotation(plane_normal(ref)).transpose(-1, -2)
    n = torch.einsum("...ij,...j->...i", R_T, plane_normal(other))
    d = plane_distance(other) - plane_distance(ref)
    return torch.stack([azimuth(n), elevation(n), d], dim=-1)


def transform(T_se3, coeffs):
    """Transform plane coefficients by an SE3 ``[q, t]`` (points map
    x' = Rx + t): ``n' = R n``, ``c' = c - t·n'`` (plane3d.h:108-115)."""
    n_new = lie.quat_rotate(T_se3[..., :4], coeffs[..., :3])
    c_new = coeffs[..., 3] - torch.sum(T_se3[..., 4:7] * n_new, dim=-1)
    return normalize(torch.cat([n_new, c_new[..., None]], dim=-1))


def transform_sim3(S, coeffs):
    """Transform plane coefficients by a Sim3 ``[q, t, s]`` (points map
    x' = s R x + t): ``n' = R n``, ``c' = s c - t·n'``, the similarity
    form of ``transform`` that carries loop corrections into planes."""
    n_new = lie.quat_rotate(S[..., :4], coeffs[..., :3])
    c_new = S[..., 7] * coeffs[..., 3] - torch.sum(S[..., 4:7] * n_new,
                                                   dim=-1)
    return normalize(torch.cat([n_new, c_new[..., None]], dim=-1))


def point_plane_distance(coeffs, p):
    """Signed distance of point(s) p from the plane (|n| = 1 assumed)."""
    return torch.sum(coeffs[..., :3] * p, dim=-1) + coeffs[..., 3]


def fit_centroid_svd(points, weights=None):
    """Weighted total-least-squares plane through a point set: the normal
    is the eigenvector of the smallest eigenvalue of the weighted scatter
    about the weighted centroid.  The normal's sign is the solver's
    (callers that need a definite side pin it themselves)."""
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype,
                             device=points.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-12)
    centroid = torch.sum(weights[..., None] * points, dim=-2) / wsum
    centered = (points - centroid[..., None, :]) * torch.sqrt(weights)[
        ..., None]
    scatter = torch.einsum("...ni,...nj->...ij", centered, centered)
    _, eigvecs = torch.linalg.eigh(scatter)
    n = eigvecs[..., :, 0]
    c = -torch.sum(n * centroid, dim=-1)
    return normalize(torch.cat([n, c[..., None]], dim=-1))
