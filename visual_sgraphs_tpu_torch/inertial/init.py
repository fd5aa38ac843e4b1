"""Visual-inertial initialisation: gravity direction, scale, velocities
and biases from keyframe poses and their preintegrations.

Port of ``visual_sgraphs_tpu/inertial/init.py`` (the reference's
``Optimizer::InertialOptimization`` and the map-rescaling half of
``LocalMapping::InitializeIMU``): the visual keyframe poses are held
fixed, and a small graph over {gravity direction (2-dof), scale (1-dof),
per-keyframe velocity, shared gyro / accel bias} is solved with the
EdgeInertialGS-equivalent factor on the LM engine's kernel route
(``optim/lm_kernels.py``: K22b, K22c on the card), the fixed poses
compacted out of the reduced system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.inertial.preintegration import (
    Preintegrated,
    pack,
)
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
from visual_sgraphs_tpu_torch.slam.map_state import MapState


class InertialInitResult(NamedTuple):
    q_wg: torch.Tensor  # (4,) gravity rotation: g_w = R_wg (0, 0, -9.81)
    scale: torch.Tensor  # ()
    vel: torch.Tensor  # (n, 3) per-keyframe body velocities
    bias_g: torch.Tensor  # (3,)
    bias_a: torch.Tensor  # (3,)
    cost0: torch.Tensor
    cost: torch.Tensor


def sqrt_info(cov):
    """Lower-Cholesky inverse of (..., 9, 9) covariances, the identity
    where the factorisation fails or is not finite (the reference's
    ``_sqrt_info``).  ``cholesky_ex`` reports a failure instead of
    synchronising to raise it."""
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(cov + eye * 1e-8)
    W = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    ok = (info == 0) & torch.isfinite(W).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], W, eye)


def preint_const(pre: Preintegrated) -> dict:
    return {"dR": pre.dR, "dV": pre.dV, "dP": pre.dP, "JRg": pre.JRg,
            "JVg": pre.JVg, "JVa": pre.JVa, "JPg": pre.JPg, "JPa": pre.JPa,
            "dt": pre.dt, "bias_g": pre.bias_g, "bias_a": pre.bias_a,
            "sqrt_info": sqrt_info(pre.cov)}


def init_problem(kf_pose, kf_valid, preint: Preintegrated, preint_valid,
                 T_bc, prior_bias_info: float = 1e4,
                 fix_scale: bool = False) -> dict:
    """The initialisation's problem: the keyword arguments of
    ``lm_kernels.optimize_reproj_inertial`` but ``iters``."""
    n = kf_pose.shape[0]
    dtype, dev = kf_pose.dtype, kf_pose.device
    T_bc = T_bc.to(dtype)
    T_wb = lie.se3_inverse(lie.se3_multiply(T_bc, kf_pose))
    p = T_wb[:, 4:7]
    dts = torch.clamp(preint.dt, min=1e-3)
    v0 = torch.zeros((n, 3), dtype=dtype, device=dev)
    v0[1:] = (p[1:] - p[:-1]) / dts[1:, None]
    v0[0] = v0[1]
    q1 = torch.zeros((1, 4), dtype=dtype, device=dev)
    q1[:, 0] = 1.0
    # the poses are fixed: they stay out of the reduced system
    red = lmk.Reduced(
        vel=v0, bg=torch.zeros((1, 3), dtype=dtype, device=dev),
        ba=torch.zeros((1, 3), dtype=dtype, device=dev), gdir=q1,
        scale=torch.ones((1, 1), dtype=dtype, device=dev))
    free = lmk.free_mask(red, {"scale": torch.full(
        (1,), fix_scale, dtype=torch.bool, device=dev)})
    idx_i = torch.arange(n - 1, dtype=torch.int32, device=dev)
    pre_j = Preintegrated(*(f[1:] for f in preint))
    valid = (preint_valid[1:] & kf_valid[:-1] & kf_valid[1:]
             & (pre_j.dt > 1e-4))
    imu = lmk.ImuRows(pre=pack(pre_j).to(dtype),
                      edge=torch.stack([idx_i, idx_i + 1], dim=1),
                      valid=valid, T_bc=T_bc, gs=True,
                      poses=kf_pose.contiguous(), prior=prior_bias_info)
    return dict(red=red, free=free, imu=imu)


def inertial_init(kf_pose, kf_valid, preint: Preintegrated, preint_valid,
                  T_bc, prior_bias_info: float = 1e4, iters: int = 30,
                  fix_scale: bool = False) -> InertialInitResult:
    """Solve gravity / scale / velocity / bias with the poses fixed.
    ``preint`` row i preintegrates keyframe i-1 -> i (row 0 unused);
    ``fix_scale`` for stereo / RGB-D (a metric visual map)."""
    res = lmk.optimize_reproj_inertial(iters=iters, **init_problem(
        kf_pose, kf_valid, preint, preint_valid, T_bc, prior_bias_info,
        fix_scale))
    return InertialInitResult(
        q_wg=lie.quat_normalize(res.red.gdir[0]),
        scale=res.red.scale[0, 0], vel=res.red.vel,
        bias_g=res.red.bg[0], bias_a=res.red.ba[0],
        cost0=res.initial_cost, cost=res.cost)


def apply_scaled_rotation(m: MapState, q_wg, scale) -> MapState:
    """Re-express the map in the gravity-aligned metric world frame
    (Map::ApplyScaledRotation): X' = s R_gw X, R_cw' = R_cw R_gwᵀ,
    t_cw' = s t_cw; afterwards gravity is exactly (0, 0, -9.81)."""
    R_gw = lie.quat_to_matrix(lie.quat_conjugate(q_wg))
    q_new = lie.quat_normalize(lie.quat_multiply(
        m.kf_pose[:, :4], q_wg.expand(m.K, 4)))
    new_pose = torch.cat([q_new, scale * m.kf_pose[:, 4:7]], dim=1)
    new_pts = scale * (m.pt_pos @ R_gw.T)
    return m._replace(
        kf_pose=torch.where(m.kf_valid[:, None], new_pose, m.kf_pose),
        pt_pos=torch.where(m.pt_valid[:, None], new_pts, m.pt_pos))


def rotate_velocities(vel, q_wg, scale):
    """Velocities transform with the same scaled rotation."""
    R_gw = lie.quat_to_matrix(lie.quat_conjugate(q_wg))
    return scale * (vel @ R_gw.T)
