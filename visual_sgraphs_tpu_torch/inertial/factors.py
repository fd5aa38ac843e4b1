"""Inertial factor residuals for the graph engine.

Port of ``visual_sgraphs_tpu/inertial/factors.py`` (the reference's
inertial g2o edges, G2oTypes.h):

- ``imu_factor``    <- EdgeInertial: the 9-dof preintegration residual
- ``imu_factor_gs`` <- EdgeInertialGS: with shared gravity-direction and
  scale variables (inertial initialisation)
- ``bias_walk``     <- EdgeGyroRW / EdgeAccRW
- ``prior_3``       <- the bias priors

Residuals are whitened inside the factor by a per-item 9x9 sqrt
information matrix.  Keyframe poses are camera poses T_cw; the residual
lives in the body frame through the camera-to-body extrinsic ``T_bc``.
Everything here is elementary tensor algebra, so ``torch.func.jacfwd``
under ``vmap`` differentiates it exactly (no ``linalg.solve`` on the
chain).
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import lie

GRAVITY = 9.81


def gravity_from_quat(q_wg):
    """World gravity g_w = R_wg (0, 0, -9.81) (VertexGDir convention)."""
    gz = torch.zeros(q_wg.shape[:-1] + (3,), dtype=q_wg.dtype,
                     device=q_wg.device)
    gz = torch.cat([gz[..., :2], gz[..., 2:] - GRAVITY], dim=-1)
    return lie.quat_rotate(q_wg, gz)


def gdir_retract(q, d):
    """2-dof update of the gravity rotation (its z-rotation is not
    observable)."""
    delta = torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)
    return lie.quat_normalize(lie.quat_multiply(q, lie.so3_exp(delta)))


def scale_retract(s, d):
    """Multiplicative scale chart (VertexScale)."""
    return s * torch.exp(d)


def _body_state(T_cw, T_bc):
    """(R_wb (3, 3), p_wb (3,)) from a camera pose and the extrinsic."""
    T_wb = lie.se3_inverse(lie.se3_multiply(T_bc, T_cw))
    return lie.quat_to_matrix(T_wb[..., :4]), T_wb[..., 4:7]


def _imu_residual(T_i, T_j, v_i, v_j, bg, ba, g_w, scale, const):
    """Shared core of the preintegration residual (Forster eq. 37-39)."""
    R_i, p_i = _body_state(T_i, const["T_bc"])
    R_j, p_j = _body_state(T_j, const["T_bc"])
    dt = const["dt"]
    dbg = bg - const["bias_g"]
    dba = ba - const["bias_a"]
    dR = lie.quat_multiply(const["dR"], lie.so3_exp(const["JRg"] @ dbg))
    dV = const["dV"] + const["JVg"] @ dbg + const["JVa"] @ dba
    dP = const["dP"] + const["JPg"] @ dbg + const["JPa"] @ dba
    RiT = R_i.T
    r_R = lie.so3_log(lie.quat_multiply(lie.quat_conjugate(dR),
                                        lie.matrix_to_quat(RiT @ R_j)))
    r_V = RiT @ (scale * (v_j - v_i) - g_w * dt) - dV
    r_P = RiT @ (scale * (p_j - p_i - v_i * dt) - 0.5 * g_w * dt * dt) - dP
    return const["sqrt_info"] @ torch.cat([r_R, r_V, r_P])


def imu_factor(values, const):
    """families (pose_i, pose_j, vel_i, vel_j, bias_g, bias_a); gravity is
    the constant ``const["g_w"]`` (after initialisation)."""
    T_i, T_j, v_i, v_j, bg, ba = values
    one = torch.ones((), dtype=T_i.dtype, device=T_i.device)
    return _imu_residual(T_i, T_j, v_i, v_j, bg, ba, const["g_w"], one,
                         const)


def imu_factor_gs(values, const):
    """families (pose_i, pose_j, vel_i, vel_j, bias_g, bias_a, gdir,
    scale): the initialisation variant."""
    T_i, T_j, v_i, v_j, bg, ba, q_wg, s = values
    return _imu_residual(T_i, T_j, v_i, v_j, bg, ba, gravity_from_quat(q_wg),
                         s[0], const)


def bias_walk(values, const):
    """families (bias_i, bias_j): r = b_j - b_i."""
    b_i, b_j = values
    return b_j - b_i


def prior_3(values, const):
    """families (x,): r = x - mean."""
    (x,) = values
    return x - const["mean"]
