"""Factor residuals for the graph engine.

Port of the reprojection, plane / room / door and ``relative_sim3``
factors of ``visual_sgraphs_tpu/optim/factors.py``.  Each function is a
per-item residual ``f(values: tuple, const: dict) -> (res_dim,)`` for a
``FactorBatch``; Jacobians come from forward-mode autodiff.  Keyframe poses
are T_cw.

- ``reproj_mono`` / ``reproj_stereo`` <- EdgeSE3ProjectXYZ /
  EdgeStereoSE3ProjectXYZ (OptimizableTypes.h:34-157)
- ``plane_kf``      <- EdgeVertexPlaneProjectSE3KF (OptimizableTypes.h:336)
- ``point_on_plane`` <- EdgeVertexPlaneProjectPointXYZ (OptimizableTypes.h:379)
- ``plane_quadric`` <- EdgeSE3KFPointToPlane (OptimizableTypes.h:296)
- ``room_2wall`` / ``room_4wall`` <- EdgeVertex{2,4}PlaneProjectSE3Room
- ``door_room``     <- EdgeSE3DoorProjectSE3Room (translation part)
- ``relative_sim3`` <- EdgeSim3, the essential-graph edge of loop closing
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.core import plane as plane_mod


def reproj_mono(values, const):
    """families (kf_pose T_cw, point X_w); const uv (2,), cam (4,)."""
    T_cw, X_w = values
    p_cam = lie.se3_apply(T_cw, X_w)
    return cameras.project_pinhole(const["cam"], p_cam) - const["uv"]


def reproj_stereo(values, const):
    """families (kf_pose T_cw, point X_w); const uv_ur (3,), cam (4,),
    bf (): the third row is the right-image u = u - bf / z."""
    T_cw, X_w = values
    p_cam = lie.se3_apply(T_cw, X_w)
    uv_hat = cameras.project_pinhole(const["cam"], p_cam)
    z = torch.clamp(p_cam[2], min=1e-6)
    ur_hat = uv_hat[0] - const["bf"] / z
    return torch.cat([uv_hat, ur_hat[None]]) - const["uv_ur"]


def point_on_plane(values, const):
    """families (plane_w, point X_w): r = n·x + d."""
    pi_w, X_w = values
    return plane_mod.point_plane_distance(pi_w, X_w)[None]


def plane_kf(values, const):
    """families (kf_pose T_cw, plane_w); const pi_obs (4,):
    r = (T_cw · pi_w) ⊖ pi_obs in the minimal chart."""
    T_cw, pi_w = values
    pi_local = plane_mod.transform(T_cw, pi_w)
    return plane_mod.ominus(const["pi_obs"], pi_local)


def plane_quadric(values, const):
    """families (kf_pose T_cw, plane_w); const G (4, 4) point quadric of
    the keyframe's supporting cloud in the camera frame.  Returns
    sqrt(pi_localᵀ G pi_local), so the squared norm is the weighted mean
    squared point-to-plane distance."""
    T_cw, pi_w = values
    pi_local = plane_mod.transform(T_cw, pi_w)
    e = pi_local @ const["G"] @ pi_local
    return torch.sqrt(torch.clamp(e, min=1e-12))[None]


def _room_pair_vec(w1, w2):
    """Mid-surface anchor point of a facing wall pair (getRoomCenter, with
    the d <= 0 direction normalisation, branch-free)."""
    w1 = torch.where(w1[3] > 0, -w1, w1)
    w2 = torch.where(w2[3] > 0, -w2, w2)
    d1, d2 = torch.abs(w1[3]), torch.abs(w2[3])
    big = torch.where(d1 > d2, w1, w2)
    small = torch.where(d1 > d2, w2, w1)
    db, ds = torch.abs(big[3]), torch.abs(small[3])
    return 0.5 * (db * big[:3] - ds * small[:3]) + ds * small[:3]


def room_2wall(values, const):
    """families (room_center, plane_w, plane_w): r = c - pairVec(w1, w2)."""
    c, w1, w2 = values
    return c - _room_pair_vec(w1, w2)


def room_4wall(values, const):
    """families (room_center, x1, x2, y1, y2):
    r = c - (pairVec(x1, x2) + pairVec(y1, y2))."""
    c, x1, x2, y1, y2 = values
    return c - (_room_pair_vec(x1, x2) + _room_pair_vec(y1, y2))


def door_room(values, const):
    """families (door_pose T_wd, room_center); const rel (3,):
    r = (t_door - c) - rel."""
    T_wd, c = values
    return (T_wd[4:7] - c) - const["rel"]


def relative_sim3(values, const):
    """families (sim3_i, sim3_j); const S_ji (8,):
    r = log(S_ji_meas^-1 . S_j . S_i^-1)."""
    S_i, S_j = values
    S_ji = lie.sim3_multiply(S_j, lie.sim3_inverse(S_i))
    return lie.sim3_log(lie.sim3_multiply(lie.sim3_inverse(const["S_ji"]),
                                          S_ji))
