"""Visual-inertial initialisation: gravity direction, scale, velocities
and biases from keyframe poses and their preintegrations.

Port of ``visual_sgraphs_tpu/inertial/init.py`` (the reference's
``Optimizer::InertialOptimization`` and the map-rescaling half of
``LocalMapping::InitializeIMU``): the visual keyframe poses are held
fixed, and a small graph over {gravity direction (2-dof), scale (1-dof),
per-keyframe velocity, shared gyro / accel bias} is solved on the generic
LM engine (``optim/solve.py``) with the EdgeInertialGS-equivalent factor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.inertial import factors as ifac
from visual_sgraphs_tpu_torch.inertial.preintegration import Preintegrated
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    gdir_family,
    point_family,
    scale_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.optim.solve import optimize
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


def inertial_init(kf_pose, kf_valid, preint: Preintegrated, preint_valid,
                  T_bc, prior_bias_info: float = 1e4, iters: int = 30,
                  fix_scale: bool = False) -> InertialInitResult:
    """Solve gravity / scale / velocity / bias with the poses fixed.
    ``preint`` row i preintegrates keyframe i-1 -> i (row 0 unused);
    ``fix_scale`` for stereo / RGB-D (a metric visual map)."""
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
    families = {
        "pose": se3_family(kf_pose, torch.ones((n,), dtype=torch.bool,
                                               device=dev)),
        "vel": point_family(v0),
        "bg": point_family(torch.zeros((1, 3), dtype=dtype, device=dev)),
        "ba": point_family(torch.zeros((1, 3), dtype=dtype, device=dev)),
        "gdir": gdir_family(q1),
        "scale": scale_family(torch.ones((1, 1), dtype=dtype, device=dev),
                              torch.full((1,), fix_scale, dtype=torch.bool,
                                         device=dev)),
    }
    m = n - 1
    idx_i = torch.arange(m, dtype=torch.int32, device=dev)
    idx_j = idx_i + 1
    zeros = torch.zeros((m,), dtype=torch.int32, device=dev)
    var_idx = torch.stack([idx_i, idx_j, idx_i, idx_j, zeros, zeros, zeros,
                           zeros], dim=1)
    pre_j = Preintegrated(*(f[1:] for f in preint))
    const = preint_const(pre_j)
    const["T_bc"] = T_bc.expand(m, 7)
    valid = (preint_valid[1:] & kf_valid[:-1] & kf_valid[1:]
             & (pre_j.dt > 1e-4))
    ones = torch.ones((m,), dtype=dtype, device=dev)
    imu_batch = FactorBatch(
        ("pose", "pose", "vel", "vel", "bg", "ba", "gdir", "scale"),
        ifac.imu_factor_gs, 9, var_idx, const, ones, valid)
    one_idx = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    priors = [FactorBatch(
        (fam,), ifac.prior_3, 3, one_idx,
        {"mean": torch.zeros((1, 3), dtype=dtype, device=dev)},
        torch.full((1,), prior_bias_info, dtype=dtype, device=dev),
        torch.ones((1,), dtype=torch.bool, device=dev)) for fam in ("bg",
                                                                   "ba")]
    res = optimize(GraphProblem(families=families,
                                factors=[imu_batch, *priors]), iters=iters)
    return InertialInitResult(
        q_wg=lie.quat_normalize(res.values["gdir"][0]),
        scale=res.values["scale"][0, 0], vel=res.values["vel"],
        bias_g=res.values["bg"][0], bias_a=res.values["ba"][0],
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
