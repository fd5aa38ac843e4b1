"""IMU preintegration à la Forster et al. (kernel K18).

Port of ``visual_sgraphs_tpu/inertial/preintegration.py`` (the
reference's ``IMU::Preintegrated``, ImuTypes.cc): the per-sample update of
(ΔR, ΔV, ΔP), the 9x9 covariance propagation A Σ Aᵀ + B Ση Bᵀ / dt and
the five bias Jacobians, in float32 as the reference integrates.

``preint_frame`` integrates one frame window of up to ``FRAME_IMU_CAP``
samples, folds it into a running keyframe-to-keyframe window and, given
the last frame's pose and velocity, makes the dead-reckoned prediction
(``predict_state``) from the frame window, all in one call: kernel K18
(``csrc/preint.cu``, one launch) on CUDA tensors, the plain twin
``preint_frame_torch`` (the reference's scan, ``merge`` and
``predict_state``) on CPU tensors.  ``preintegrate_merge`` is the same
kernel for ``Preintegrated`` operands.

A ``Preintegrated`` crosses the kernel boundary packed as one float32
vector of ``PACKED`` entries (``pack`` / ``unpack``; ``unpack`` returns
views): the keyframe window goes in packed and the kernel writes the
frame window and the merged window packed, so a caller that keeps the
keyframe window packed packs nothing per frame.  Samples cross as one
(T, 8) float32 table [ωx ωy ωz ax ay az dt valid].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import lie

GRAVITY = 9.81


class Preintegrated(NamedTuple):
    """Preintegrated IMU measurements between two frames / keyframes
    (fields may carry leading batch dimensions)."""

    dR: torch.Tensor  # (4,) quaternion ΔR_ij
    dV: torch.Tensor  # (3,)
    dP: torch.Tensor  # (3,)
    JRg: torch.Tensor  # (3, 3) bias Jacobians at the linearisation bias
    JVg: torch.Tensor  # (3, 3)
    JVa: torch.Tensor  # (3, 3)
    JPg: torch.Tensor  # (3, 3)
    JPa: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (9, 9) covariance of (r_R, r_V, r_P)
    dt: torch.Tensor  # () total integration time
    bias_g: torch.Tensor  # (3,) linearisation gyro bias
    bias_a: torch.Tensor  # (3,) linearisation accel bias


_SHAPES = dict(dR=(4,), dV=(3,), dP=(3,), JRg=(3, 3), JVg=(3, 3),
               JVa=(3, 3), JPg=(3, 3), JPa=(3, 3), cov=(9, 9), dt=(),
               bias_g=(3,), bias_a=(3,))
_SIZES = [int(np.prod(_SHAPES[k])) for k in Preintegrated._fields]
PACKED = sum(_SIZES)  # 143 floats


def pack(pre: Preintegrated) -> torch.Tensor:
    """(..., PACKED) float32, fields in declaration order."""
    batch = pre.dV.shape[:-1]
    return torch.cat([f.reshape(batch + (-1,)) for f in pre], dim=-1)


def unpack(vec: torch.Tensor) -> Preintegrated:
    """Views of a packed (..., PACKED) tensor as a ``Preintegrated``."""
    batch = vec.shape[:-1]
    out, off = [], 0
    for k, n in zip(Preintegrated._fields, _SIZES):
        out.append(vec[..., off:off + n].reshape(batch + _SHAPES[k]))
        off += n
    return Preintegrated(*out)


def identity_preint(bias_g=None, bias_a=None, dtype=torch.float32,
                    device=None) -> Preintegrated:
    if bias_g is not None:
        device = bias_g.device
    z3 = torch.zeros((3,), dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    dR = torch.cat([torch.ones((1,), dtype=dtype, device=device),
                    torch.zeros((3,), dtype=dtype, device=device)])
    return Preintegrated(
        dR=dR, dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
        dt=torch.zeros((), dtype=dtype, device=device),
        bias_g=bias_g if bias_g is not None else z3,
        bias_a=bias_a if bias_a is not None else z3)


def _step(s: Preintegrated, omega, acc, dt, valid, ng2: float, na2: float):
    """One IntegrateNewMeasurement step (ImuTypes.cc): position and
    velocity with the current ΔR, covariance and Jacobian propagation,
    then the rotation update; a padded sample leaves the state as it
    was."""
    w = omega - s.bias_g
    a = acc - s.bias_a
    dtv = torch.where(valid, dt, 0.0)
    R = lie.quat_to_matrix(s.dR)
    Ra = R @ a
    dP = s.dP + s.dV * dtv + 0.5 * Ra * dtv * dtv
    dV = s.dV + Ra * dtv
    ahat = lie.hat(a)
    dRk = lie.so3_exp(w * dtv)
    Rk = lie.quat_to_matrix(dRk)
    dev, dtype = dP.device, dP.dtype
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    RA = R @ ahat
    A = torch.cat([
        torch.cat([Rk.T, Z3, Z3], 1),
        torch.cat([-R @ ahat * dtv, I3, Z3], 1),
        torch.cat([-0.5 * R @ ahat * dtv * dtv, I3 * dtv, I3], 1)], 0)
    Jr = lie.so3_left_jacobian(-w * dtv)
    B = torch.cat([
        torch.cat([Jr * dtv, Z3], 1),
        torch.cat([Z3, R * dtv], 1),
        torch.cat([Z3, 0.5 * R * dtv * dtv], 1)], 0)
    Sn = torch.diag(torch.cat([torch.full((3,), ng2, dtype=dtype, device=dev),
                               torch.full((3,), na2, dtype=dtype,
                                          device=dev)]))
    inv_dt = torch.where(dtv > 0, 1.0 / torch.clamp(dtv, min=1e-9), 0.0)
    cov = A @ s.cov @ A.T + B @ Sn @ B.T * inv_dt
    JPa = s.JPa + s.JVa * dtv - 0.5 * R * dtv * dtv
    JPg = s.JPg + s.JVg * dtv - 0.5 * R @ ahat @ s.JRg * dtv * dtv
    JVa = s.JVa - R * dtv
    JVg = s.JVg - RA @ s.JRg * dtv
    JRg = Rk.T @ s.JRg - Jr * dtv
    dR = lie.quat_normalize(lie.quat_multiply(s.dR, dRk))
    new = Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                        JPg=JPg, JPa=JPa, cov=cov, dt=s.dt + dtv,
                        bias_g=s.bias_g, bias_a=s.bias_a)
    return Preintegrated(*(torch.where(valid, n, o) for n, o in zip(new, s)))


def _preintegrate_plain(samples, bias_g, bias_a, noise_gyro: float,
                        noise_acc: float) -> Preintegrated:
    """The reference's ``preintegrate`` scan over a (T, 8) sample table."""
    s = identity_preint(bias_g, bias_a)
    ng2 = noise_gyro * noise_gyro
    na2 = noise_acc * noise_acc
    for i in range(samples.shape[0]):
        row = samples[i]
        s = _step(s, row[0:3], row[3:6], row[6], row[7] != 0, ng2, na2)
    return s


def merge(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Concatenate two preintegrations (the reference's merge: the
    covariances compose as A Σ_a Aᵀ + Σ_b, the Jacobians to first
    order)."""
    Ra = lie.quat_to_matrix(a.dR)
    dP = a.dP + a.dV * b.dt + Ra @ b.dP
    dV = a.dV + Ra @ b.dV
    dR = lie.quat_normalize(lie.quat_multiply(a.dR, b.dR))
    Rb = lie.quat_to_matrix(b.dR)
    dev, dtype = a.dP.device, a.dP.dtype
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    A = torch.cat([torch.cat([Rb.T, Z3, Z3], 1),
                   torch.cat([Z3, I3, Z3], 1),
                   torch.cat([Z3, I3 * b.dt, I3], 1)], 0)
    cov = A @ a.cov @ A.T + b.cov
    return Preintegrated(
        dR=dR, dV=dV, dP=dP,
        JRg=Rb.T @ a.JRg + b.JRg,
        JVg=a.JVg + Ra @ b.JVg,
        JVa=a.JVa + Ra @ b.JVa,
        JPg=a.JPg + a.JVg * b.dt + Ra @ b.JPg,
        JPa=a.JPa + a.JVa * b.dt + Ra @ b.JPa,
        cov=cov, dt=a.dt + b.dt, bias_g=a.bias_g, bias_a=a.bias_a)


def sample_table(omega, acc, dt, valid) -> torch.Tensor:
    """(T, 8) float32 [ω, a, dt, valid] from the reference's four arrays."""
    return torch.cat([omega.to(torch.float32), acc.to(torch.float32),
                      dt.to(torch.float32)[:, None],
                      valid.to(torch.float32)[:, None]], dim=1).contiguous()


def preintegrate_merge_torch(since: Preintegrated, samples, bias_g, bias_a,
                             noise_gyro: float = 1.7e-4,
                             noise_acc: float = 2.0e-3):
    """Plain twin of K18: (window, merge(since, window)) of a (T, 8)
    sample table."""
    if samples.is_cuda:
        preintegrate_merge_torch.cuda_calls += 1
    pre = _preintegrate_plain(samples, bias_g, bias_a, noise_gyro, noise_acc)
    return pre, merge(since, pre)


preintegrate_merge_torch.cuda_calls = 0


def predict_state(T_cw_i, v_i, pre: Preintegrated, T_bc):
    """IMU dead-reckoned next pose and velocity: p_j = p_i + v Δt + ½ g Δt²
    + R_wb ΔP, v_j = v_i + g Δt + R_wb ΔV.  Returns (T_cw_j, v_j).  Plain
    torch: on the card K18 makes it (``preint_frame`` with ``pose``)."""
    if T_cw_i.is_cuda:
        predict_state.cuda_calls += 1
    T_wb_i = lie.se3_inverse(lie.se3_multiply(T_bc, T_cw_i))
    q_wb_i, p_i = T_wb_i[:4], T_wb_i[4:7]
    R_wb_i = lie.quat_to_matrix(q_wb_i)
    # (0, 0, -g) made on the device: a Python number written into one
    # element of a CUDA tensor is a synchronising host copy
    g = torch.cat([torch.zeros((2,), dtype=T_cw_i.dtype,
                               device=T_cw_i.device),
                   torch.full((1,), -GRAVITY, dtype=T_cw_i.dtype,
                              device=T_cw_i.device)])
    dt = pre.dt
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + R_wb_i @ pre.dP
    v_j = v_i + g * dt + R_wb_i @ pre.dV
    q_wb_j = lie.quat_normalize(lie.quat_multiply(q_wb_i, pre.dR))
    T_cw_j = lie.se3_multiply(lie.se3_inverse(T_bc), lie.se3_inverse(
        lie.se3_from_rt(q_wb_j, p_j)))
    return lie.se3_normalize(T_cw_j), v_j


predict_state.cuda_calls = 0

# K18's output: the frame window, the merged window, the predicted pose
# (7) and velocity (3)
FRAME_OUT = 2 * PACKED + 10


def _frame_views(out: torch.Tensor, predicted: bool):
    pred = (out[2 * PACKED:2 * PACKED + 7], out[2 * PACKED + 7:])
    return out[:PACKED], out[PACKED:2 * PACKED], pred if predicted else None


def preint_frame_torch(since_vec, samples, bias_g, bias_a,
                       noise_gyro: float = 1.7e-4,
                       noise_acc: float = 2.0e-3, pose=None):
    """Plain twin of K18: ``preintegrate_merge_torch`` on the packed
    keyframe window, then, given ``pose`` = (T_cw, v, T_bc),
    ``predict_state`` from the frame window.  Returns (window, merged)
    packed and the prediction (T_cw_j, v_j) or None."""
    if samples.is_cuda:
        preint_frame_torch.cuda_calls += 1
    win, merged = preintegrate_merge_torch(unpack(since_vec), samples,
                                           bias_g, bias_a, noise_gyro,
                                           noise_acc)
    parts = [pack(win), pack(merged)]
    if pose is not None:
        parts += list(predict_state(pose[0], pose[1], win, pose[2]))
    return _frame_views(torch.cat(parts), pose is not None)


preint_frame_torch.cuda_calls = 0


def preint_frame(since_vec, samples, bias_g, bias_a,
                 noise_gyro: float = 1.7e-4, noise_acc: float = 2.0e-3,
                 pose=None):
    """One inertial frame: integrate a window of samples (a (T, 8) float32
    table, T <= 64) at the biases ``bias_g`` / ``bias_a``, fold it into
    the packed keyframe window ``since_vec`` (PACKED,) and, given ``pose``
    = (T_cw, v, T_bc) (the last frame's pose and velocity, the body-camera
    transform), predict the frame's pose and velocity from the window.
    Returns (window, merged) packed and (T_cw_j, v_j) or None, views of
    one output.  Kernel K18 (one launch) on CUDA tensors, the twin on CPU
    tensors."""
    if samples.device.type == "cpu":
        return preint_frame_torch(since_vec, samples, bias_g, bias_a,
                                  noise_gyro, noise_acc, pose)
    poses = list(pose) if pose is not None else []
    cuda.require_cuda("preint_frame", samples, bias_g, bias_a, since_vec,
                      *poses)
    if (samples.dtype != torch.float32 or samples.dim() != 2
            or samples.shape[1] != 8 or samples.shape[0] > 64
            or samples.data_ptr() % 16 or since_vec.shape != (PACKED,)
            or since_vec.dtype != torch.float32
            or any(t.dtype != torch.float32 for t in poses)
            or [t.numel() for t in poses] not in ([], [7, 3, 7])):
        raise ValueError("preint_frame: expected a 16-byte aligned (T <= 64, "
                         "8) float32 sample table, a packed window and "
                         "float32 (T_cw, v, T_bc)")
    out = torch.empty((FRAME_OUT,), dtype=torch.float32,
                      device=samples.device)
    T_cw, vel, T_bc = poses if poses else (None, None, None)
    cuda.call("vsg_preint", cuda.ptr(since_vec), cuda.ptr(samples),
              samples.shape[0], cuda.ptr(bias_g), cuda.ptr(bias_a),
              float(np.float32(noise_gyro * noise_gyro)),
              float(np.float32(noise_acc * noise_acc)), cuda.ptr(T_cw),
              cuda.ptr(vel), cuda.ptr(T_bc), cuda.ptr(out), cuda.stream())
    preint_frame.launches += 1
    return _frame_views(out, pose is not None)


preint_frame.launches = 0


def preintegrate_merge(since: Preintegrated, samples, bias_g, bias_a,
                       noise_gyro: float = 1.7e-4,
                       noise_acc: float = 2.0e-3):
    """Integrate one window of samples (a (T, 8) float32 table, T <= 64)
    at the biases ``bias_g`` / ``bias_a`` and fold it into ``since``.
    Returns (window, merged) preintegrations.  Kernel K18 on CUDA tensors
    (``preint_frame``), the twin on CPU tensors."""
    if samples.device.type == "cpu":
        return preintegrate_merge_torch(since, samples, bias_g, bias_a,
                                        noise_gyro, noise_acc)
    win, merged, _ = preint_frame(pack(since).contiguous(), samples, bias_g,
                                  bias_a, noise_gyro, noise_acc)
    return unpack(win), unpack(merged)


def preintegrate(omega, acc, dt, valid, bias_g, bias_a,
                 noise_gyro: float = 1.7e-4,
                 noise_acc: float = 2.0e-3) -> Preintegrated:
    """The reference's ``preintegrate``: ``omega`` / ``acc`` (T, 3),
    ``dt`` (T,) sample intervals, ``valid`` (T,) padding mask (K18 on
    CUDA tensors)."""
    pre, _ = preintegrate_merge(
        identity_preint(bias_g.to(torch.float32), bias_a.to(torch.float32)),
        sample_table(omega, acc, dt, valid), bias_g.to(torch.float32),
        bias_a.to(torch.float32), noise_gyro, noise_acc)
    return pre


def bias_corrected_delta(pre: Preintegrated, bias_g, bias_a):
    """First-order bias-corrected (ΔR, ΔV, ΔP) at a new bias
    (Preintegrated::GetDeltaRotation / Velocity / Position)."""
    dbg = bias_g - pre.bias_g
    dba = bias_a - pre.bias_a
    dR = lie.quat_multiply(pre.dR, lie.so3_exp(pre.JRg @ dbg))
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    return dR, dV, dP
