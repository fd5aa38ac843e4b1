"""Visual-inertial local BA over a temporal keyframe window.

Port of ``visual_sgraphs_tpu/inertial/vi_ba.py`` (the reference's
``Optimizer::LocalInertialBA``): the last W keyframe slots with their
velocities and biases, reprojection factors to the points they observe
(Schur-eliminated; the point set is compacted by kernel K7),
preintegration factors chaining consecutive slots and bias random-walk
factors, on the LM engine's kernel route (``optim/lm_kernels.py``: K22a,
K22b, K22c on the card).  The oldest valid slot is the gauge anchor.

Tables are updated functionally (a new ``ImuKfState`` per call), as in
the reference; they are a few kilobytes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch.inertial.preintegration import (
    PACKED,
    Preintegrated,
    identity_preint,
    pack,
    unpack,
)
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
from visual_sgraphs_tpu_torch.slam.map_state import MapState, index_set_last
from visual_sgraphs_tpu_torch.slam.mapping import window_rows, write_window


class ImuKfState(NamedTuple):
    """Per-keyframe inertial tables (capacity K): velocity, biases and
    the preintegration from the previous keyframe (row k: k-1 -> k)."""

    vel: torch.Tensor  # (K, 3)
    bias_g: torch.Tensor  # (K, 3)
    bias_a: torch.Tensor  # (K, 3)
    preint: Preintegrated  # stacked (K, ...), views of one (K, 143) table
    preint_valid: torch.Tensor  # (K,) bool


def empty_imu_state(max_keyframes: int, device=None) -> ImuKfState:
    K = max_keyframes
    one = pack(identity_preint(device=device))
    return ImuKfState(
        vel=torch.zeros((K, 3), dtype=torch.float32, device=device),
        bias_g=torch.zeros((K, 3), dtype=torch.float32, device=device),
        bias_a=torch.zeros((K, 3), dtype=torch.float32, device=device),
        preint=unpack(one.expand(K, PACKED).clone()),
        preint_valid=torch.zeros((K,), dtype=torch.bool, device=device))


def set_kf_imu(s: ImuKfState, kf: int, vel, bias_g, bias_a,
               preint: Preintegrated, preint_valid: bool) -> ImuKfState:
    """Row ``kf`` of every table set (a new state)."""
    table = pack(s.preint).clone()
    table[kf] = pack(preint)
    valid = s.preint_valid.clone()
    # a fill, not a host copy of a Python bool into one element
    valid[kf:kf + 1].fill_(bool(preint_valid))
    rows = []
    for tab, row in ((s.vel, vel), (s.bias_g, bias_g), (s.bias_a, bias_a)):
        tab = tab.clone()
        tab[kf] = row
        rows.append(tab)
    return ImuKfState(*rows, preint=unpack(table), preint_valid=valid)


def vi_problem(m: MapState, imu: ImuKfState, kf_id: int, cam_K, cam_bf,
               T_bc, walk_gyro: float, walk_acc: float, n_window: int,
               n_local_pts: int):
    """The VI local BA's window: (kf_ids, kf_mask, safe_pt, pt_ok, the
    keyword arguments of ``lm_kernels.optimize_reproj_inertial`` but
    ``iters``)."""
    W = n_window
    dev = m.kf_pose.device
    kf_ids = kf_id - W + 1 + torch.arange(W, device=dev)
    in_range = kf_ids >= 0
    kf_ids = torch.clamp(kf_ids, min=0)
    kf_mask = in_range & m.kf_valid[kf_ids]
    safe_pt, pt_ok, rows = window_rows(m, kf_ids, kf_mask, cam_bf,
                                       n_local_pts)

    # the IMU chain: the preintegration row of slot j joins (j - 1, j)
    E = W - 1
    e_i = torch.arange(E, dtype=torch.int32, device=dev)
    e_j = e_i + 1
    rows_j = kf_ids[e_j.long()]
    pre = Preintegrated(*(f[rows_j] for f in imu.preint))
    imu_valid = (imu.preint_valid[rows_j] & kf_mask[:-1] & kf_mask[1:]
                 & (pre.dt > 1e-4))
    dtv = torch.clamp(pre.dt, min=1e-3)
    imu_rows = lmk.ImuRows(
        pre=pack(pre), edge=torch.stack([e_i, e_j], dim=1), valid=imu_valid,
        T_bc=T_bc, gs=False, info_g=1.0 / (walk_gyro * walk_gyro * dtv),
        info_a=1.0 / (walk_acc * walk_acc * dtv))

    # the oldest valid window slot is the gauge anchor
    first = torch.argmax(kf_mask.to(torch.int32))
    slot_fixed = (~kf_mask) | (torch.arange(W, device=dev) == first)
    red = lmk.Reduced(pose=m.kf_pose[kf_ids], vel=imu.vel[kf_ids],
                      bg=imu.bias_g[kf_ids], ba=imu.bias_a[kf_ids])
    free = lmk.free_mask(red, {k: slot_fixed for k in ("pose", "vel", "bg",
                                                       "ba")})
    return kf_ids, kf_mask, safe_pt, pt_ok, dict(
        red=red, free=free, pts=m.pt_pos[safe_pt], pt_fixed=~pt_ok,
        rows=rows, cam=cam_K, bf=cam_bf, imu=imu_rows)


def vi_local_ba(m: MapState, imu: ImuKfState, kf_id: int, cam_K, cam_bf,
                T_bc, walk_gyro: float = 1.9e-5, walk_acc: float = 3.0e-3,
                n_window: int = 10, n_local_pts: int = 4096,
                iters: int = 8):
    """Joint solve of the last ``n_window`` keyframe slots' poses,
    velocities and biases with their local points.  Returns (map,
    imu_state, final cost as a device scalar)."""
    kf_ids, kf_mask, safe_pt, pt_ok, problem = vi_problem(
        m, imu, kf_id, cam_K, cam_bf, T_bc, walk_gyro, walk_acc, n_window,
        n_local_pts)
    res = lmk.optimize_reproj_inertial(iters=iters, **problem)

    new_m = write_window(m, kf_ids, kf_mask, res.red.pose, safe_pt, pt_ok,
                         res.pts)
    upd = kf_mask[:, None]
    tables = [index_set_last(tab.clone(), kf_ids,
                             torch.where(upd, val, tab[kf_ids]))
              for val, tab in ((res.red.vel, imu.vel),
                               (res.red.bg, imu.bias_g),
                               (res.red.ba, imu.bias_a))]
    return new_m, imu._replace(vel=tables[0], bias_g=tables[1],
                               bias_a=tables[2]), res.cost
