"""Scene-graph factor residuals for the graph engine.

Port of the plane / room / door part of
``visual_sgraphs_tpu/optim/factors.py``.  Each function is a per-item
residual ``f(values: tuple, const: dict) -> (res_dim,)`` for a
``FactorBatch``; Jacobians come from forward-mode autodiff.  Keyframe poses
are T_cw.

- ``plane_kf``      <- EdgeVertexPlaneProjectSE3KF (OptimizableTypes.h:336)
- ``plane_quadric`` <- EdgeSE3KFPointToPlane (OptimizableTypes.h:296)
- ``room_2wall`` / ``room_4wall`` <- EdgeVertex{2,4}PlaneProjectSE3Room
- ``door_room``     <- EdgeSE3DoorProjectSE3Room (translation part)
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import plane as plane_mod


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
