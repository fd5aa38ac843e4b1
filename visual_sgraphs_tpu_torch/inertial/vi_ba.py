"""Visual-inertial local BA over a temporal keyframe window.

Port of ``visual_sgraphs_tpu/inertial/vi_ba.py`` (the reference's
``Optimizer::LocalInertialBA``): the last W keyframe slots with their
velocities and biases, reprojection factors to the points they observe
(Schur-eliminated; the point set is compacted by kernel K7),
preintegration factors chaining consecutive slots and bias random-walk
factors, on the generic LM engine.  The oldest valid slot is the gauge
anchor.

Tables are updated functionally (a new ``ImuKfState`` per call), as in
the reference; they are a few kilobytes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch.inertial import factors as ifac
from visual_sgraphs_tpu_torch.inertial.init import preint_const
from visual_sgraphs_tpu_torch.inertial.preintegration import (
    PACKED,
    Preintegrated,
    identity_preint,
    pack,
    unpack,
)
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    point_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.optim.solve import optimize
from visual_sgraphs_tpu_torch.slam.map_state import MapState, index_set_last
from visual_sgraphs_tpu_torch.slam.mapping import reproj_window, write_window


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


def vi_local_ba(m: MapState, imu: ImuKfState, kf_id: int, cam_K, cam_bf,
                T_bc, walk_gyro: float = 1.9e-5, walk_acc: float = 3.0e-3,
                n_window: int = 10, n_local_pts: int = 4096,
                iters: int = 8):
    """Joint solve of the last ``n_window`` keyframe slots' poses,
    velocities and biases with their local points.  Returns (map,
    imu_state, final cost as a device scalar)."""
    W = n_window
    dev = m.kf_pose.device
    kf_ids = kf_id - W + 1 + torch.arange(W, device=dev)
    in_range = kf_ids >= 0
    kf_ids = torch.clamp(kf_ids, min=0)
    kf_mask = in_range & m.kf_valid[kf_ids]
    safe_pt, pt_ok, batches = reproj_window(m, kf_ids, kf_mask, cam_K,
                                            cam_bf, n_local_pts)

    # the IMU chain: the preintegration row of slot j joins (j - 1, j)
    E = W - 1
    e_i = torch.arange(E, dtype=torch.int32, device=dev)
    e_j = e_i + 1
    rows = kf_ids[e_j.long()]
    pre = Preintegrated(*(f[rows] for f in imu.preint))
    imu_valid = (imu.preint_valid[rows] & kf_mask[:-1] & kf_mask[1:]
                 & (pre.dt > 1e-4))
    g_w = torch.zeros((E, 3), dtype=torch.float32, device=dev)
    g_w[:, 2:].fill_(-ifac.GRAVITY)
    const = preint_const(pre)
    const["T_bc"] = T_bc.expand(E, 7)
    const["g_w"] = g_w
    ones = torch.ones((E,), dtype=torch.float32, device=dev)
    batches.append(FactorBatch(
        ("kf", "kf", "vel", "vel", "bg", "ba"), ifac.imu_factor, 9,
        torch.stack([e_i, e_j, e_i, e_j, e_j, e_j], dim=1), const, ones,
        imu_valid, huber=9.0))
    dtv = torch.clamp(pre.dt, min=1e-3)
    for fam, walk in (("bg", walk_gyro), ("ba", walk_acc)):
        batches.append(FactorBatch(
            (fam, fam), ifac.bias_walk, 3, torch.stack([e_i, e_j], dim=1),
            {}, 1.0 / (walk * walk * dtv), imu_valid))

    # the oldest valid window slot is the gauge anchor
    first = torch.argmax(kf_mask.to(torch.int32))
    slot_fixed = (~kf_mask) | (torch.arange(W, device=dev) == first)
    problem = GraphProblem(
        families={
            "kf": se3_family(m.kf_pose[kf_ids], slot_fixed),
            "vel": point_family(imu.vel[kf_ids], slot_fixed),
            "bg": point_family(imu.bias_g[kf_ids], slot_fixed),
            "ba": point_family(imu.bias_a[kf_ids], slot_fixed),
            "pt": point_family(m.pt_pos[safe_pt], ~pt_ok),
        },
        factors=batches, eliminated="pt")
    res = optimize(problem, iters=iters)

    new_m = write_window(m, kf_ids, kf_mask, res.values["kf"], safe_pt,
                         pt_ok, res.values["pt"])
    upd = kf_mask[:, None]
    tables = [index_set_last(tab.clone(), kf_ids,
                             torch.where(upd, res.values[k], tab[kf_ids]))
              for k, tab in (("vel", imu.vel), ("bg", imu.bias_g),
                             ("ba", imu.bias_a))]
    return new_m, imu._replace(vel=tables[0], bias_g=tables[1],
                               bias_a=tables[2]), res.cost
