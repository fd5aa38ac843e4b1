"""Analytic windowed bundle adjustment — the keyframe path's local BA.

Port of ``fast_local_ba`` and ``fast_scenegraph_ba`` from
``visual_sgraphs_tpu/optim/fast_ba.py`` (Optimizer::LocalBundleAdjustment,
Optimizer.cc:1454, with the vS-Graphs plane / room / door blocks of
Optimizer.cc:2049-2260): the reference keyframe plus its ``n_window`` most
covisible keyframes and every valid point they observe; the oldest local
keyframe (and keyframe 0) is the gauge anchor.  Each Gauss-Newton
iteration reduces the landmarks with the Schur kernel K8
(``parallel/dist_ba.py``), adds the scene-graph factor blocks (linearised
and assembled by kernel K21, ``csrc/sg_assemble.cu``; its twin is the
generic ``optim/graph.py`` linearisation) as dense rows of the same
system, with the keyframe block and its right-hand side added in the same
launch, solves it and retracts every variable in one launch (kernel K26,
``parallel/dist_ba.py::ba_solve``) and back-substitutes and moves the
points in K8's second launch.

Layout of the reduced tangent vector of the scene-graph variant:
    [ kf (L, 6) | plane (P, 3) | room (R, 3) | door (D, 6) ]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.config import SceneGraphConfig
from visual_sgraphs_tpu_torch.core import plane as plane_mod
from visual_sgraphs_tpu_torch.optim import factors as factors_mod
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    linearize_batch,
    plane_family,
    point_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.parallel.dist_ba import (
    back_substitute,
    ba_solve,
    group_observations,
    local_reduced_system,
)
from visual_sgraphs_tpu_torch.scenegraph.manager import plane_covis_bonus
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    compact_observed,
    covisibility_counts,
    index_set_last,
)
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable


def _window(m: MapState, kf_id: int, counts, n_window: int):
    """(kf_ids (L,), kf_mask (L,)): ``kf_id`` and its top ``n_window``
    covisible keyframes (lax.top_k's tie order)."""
    dev = m.kf_pose.device
    top_counts, top_kfs = topk_stable(counts, n_window)
    kf_ids = torch.cat([torch.full((1,), kf_id, device=dev), top_kfs])
    kf_mask = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         top_counts > 0]) & m.kf_valid[kf_ids]
    return kf_ids, kf_mask


def _observation_tables(m: MapState, kf_ids, kf_mask, cam_bf,
                        n_local_pts: int, max_obs: int):
    """Local points and per-landmark observation tables of the window.
    Returns (safe_pt, pt_ok, kf_tab, uvr_tab, val_tab, bf)."""
    dev = m.kf_pose.device
    L = kf_ids.shape[0]
    obs = m.kf_obs_pt[kf_ids]
    obs_safe = torch.clamp(obs, min=0).long()
    obs_ok = (m.kf_kp_valid[kf_ids] & kf_mask[:, None] & (obs >= 0)
              & m.pt_valid[obs_safe])
    local_pt = compact_observed(m, kf_ids, kf_mask, n_local_pts)
    pt_ok = local_pt >= 0
    safe_pt = torch.clamp(local_pt, min=0)
    inv = torch.full((m.N + 1,), -1, dtype=torch.int32, device=dev)
    index_set_last(inv, safe_pt + 1, torch.where(
        pt_ok, torch.arange(n_local_pts, dtype=torch.int32, device=dev), -1))
    pt_local_idx = inv[obs_safe + 1]
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = torch.arange(L, dtype=torch.int32, device=dev)[:, None].expand(
        obs.shape)
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    if cam_bf is None:
        bf = torch.zeros((), dtype=torch.float32, device=dev)
        ur = torch.full_like(depth, -1.0)
    else:
        bf = cam_bf
        ur = torch.where(depth > 0,
                         uv[:, 0] - bf / torch.clamp(depth, min=1e-3), -1.0)
    uvr = torch.cat([uv, ur[:, None]], dim=1)
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        kf_rows.reshape(-1), pt_local_idx.reshape(-1), uvr,
        use.reshape(-1), n_local_pts, max_obs)
    return safe_pt, pt_ok, kf_tab, uvr_tab, val_tab, bf


def _write_back(m: MapState, kf_ids, kf_mask, kf_fixed, poses, safe_pt,
                pt_ok, pts) -> MapState:
    new_kf_pose = index_set_last(
        m.kf_pose.clone(), kf_ids,
        torch.where((kf_mask & ~kf_fixed)[:, None], poses, m.kf_pose[kf_ids]))
    new_pt_pos = index_set_last(
        m.pt_pos.clone(), safe_pt,
        torch.where(pt_ok[:, None], pts, m.pt_pos[safe_pt]))
    return m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos)


def fast_local_ba(m: MapState, kf_id: int, cam_K: torch.Tensor,
                  cam_bf: torch.Tensor | None = None, n_window: int = 10,
                  n_local_pts: int = 8192, max_obs: int = 12,
                  iters: int = 10, lam: float = 1e-4):
    """Analytic windowed BA (reprojection + RGB-D disparity rows).
    Returns (map, final cost as a device scalar)."""
    kf_ids, kf_mask = _window(m, kf_id, covisibility_counts(m, kf_id),
                              n_window)
    L = kf_ids.shape[0]
    safe_pt, pt_ok, kf_tab, uvr_tab, val_tab, bf = _observation_tables(
        m, kf_ids, kf_mask, cam_bf, n_local_pts, max_obs)

    min_id = torch.min(torch.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    if cam_bf is None:
        min2_id = torch.min(torch.where(kf_mask & (kf_ids != min_id),
                                        kf_ids, m.K))
        kf_fixed = kf_fixed | (kf_ids == min2_id)

    poses = m.kf_pose[kf_ids]
    pts = m.pt_pos[safe_pt]
    free = (~kf_fixed).repeat_interleave(6).to(poses.dtype)
    cost = None
    if poses.is_cuda:
        fast_local_ba.cuda_iters += iters
    for _ in range(iters):
        S, rhs, Hinv, bx, W, cost = local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, 2.45)
        dx, poses, *_ = ba_solve(S, rhs, free, lam, poses)
        pts = back_substitute(Hinv, bx, W, kf_tab, val_tab, dx.view(L, 6),
                              pts, pt_ok)
    return _write_back(m, kf_ids, kf_mask, kf_fixed, poses, safe_pt, pt_ok,
                       pts), cost


# iterations on the card (K26 launches once each)
fast_local_ba.cuda_iters = 0


def _assemble_dense(problem: GraphProblem, values: dict):
    """Dense H, g over the problem's (non-eliminated) families."""
    fams = {k: dataclasses.replace(problem.families[k], values=values[k])
            for k in problem.families}
    D = problem.reduced_dim()
    ref = next(iter(values.values()))
    H = torch.zeros((D, D), dtype=ref.dtype, device=ref.device)
    g = torch.zeros((D,), dtype=ref.dtype, device=ref.device)
    offs = problem.offsets()

    def cols(name, idx):
        t = problem.families[name].tangent_dim
        return (offs[name] + idx.long()[:, None] * t
                + torch.arange(t, device=idx.device)[None, :])

    for batch in problem.factors:
        r, jacs, w = linearize_batch(batch, fams)
        names = batch.families
        for i, ni in enumerate(names):
            ci = cols(ni, batch.var_idx[:, i])
            g.index_put_((ci,), torch.einsum("mri,mr->mi", jacs[i], r)
                         * w[:, None], accumulate=True)
            for j in range(i, len(names)):
                cj = cols(names[j], batch.var_idx[:, j])
                block = torch.einsum("mri,mrj->mij", jacs[i], jacs[j]) \
                    * w[:, None, None]
                H.index_put_((ci[:, :, None], cj[:, None, :]), block,
                             accumulate=True)
                if i != j:
                    H.index_put_((cj[:, :, None], ci[:, None, :]),
                                 block.transpose(-1, -2), accumulate=True)
    return H, g


# Huber widths (whitened units) of the five scene-graph factor types, in
# K21's order: plane-KF, Gij quadric, 4-wall room, 2-wall room, door-room
SG_HUBER = (2.79, 1.96, 1.0, 1.0, 1.0)


class SgFactors(NamedTuple):
    """The constant operands of one scene-graph BA call's five factor
    batches (the reference's ``_scenegraph_batches``), built once before
    the iterations: variable rows, per-item constants, information and
    validity (False for every item of a type that the configuration turns
    off).  Index rows are clamped to >= 0; an item that points at a -1
    slot is invalid and carries weight 0."""

    ob_idx: torch.Tensor  # (Q, 2) int32 [local keyframe, plane]
    ob_coeffs: torch.Tensor  # (Q, 4) observed plane, camera frame
    ob_info: torch.Tensor  # (Q,) plane-KF information
    ob_valid: torch.Tensor  # (Q,) bool, plane-KF items
    ob_quadric: torch.Tensor  # (Q, 4, 4) point quadric, camera frame
    quad_info: torch.Tensor  # (Q,)
    quad_valid: torch.Tensor  # (Q,) bool, Gij-quadric items
    room_idx: torch.Tensor  # (R, 5) int32 [room, wall 0-3]
    room_info: torch.Tensor  # (R,)
    room4_valid: torch.Tensor  # (R,) bool, 4-wall rooms
    room2_valid: torch.Tensor  # (R,) bool, 2-wall rooms (corridors)
    door_idx: torch.Tensor  # (Dn, 2) int32 [door, room]
    door_rel: torch.Tensor  # (Dn, 3) door-room offset
    door_info: torch.Tensor  # (Dn,)
    door_valid: torch.Tensor  # (Dn,) bool


def _scenegraph_factors(sg, ob_local_kf, config: SceneGraphConfig):
    """The factor operands (``SgFactors``) and the fixed masks of the
    plane / room / door families."""
    P = sg.P
    dev = sg.pl_coeffs.device
    ob_use = sg.ob_valid & (sg.ob_plane >= 0) & (ob_local_kf >= 0)
    ob_idx = torch.stack([torch.clamp(ob_local_kf, min=0),
                          torch.clamp(sg.ob_plane, min=0)],
                         dim=1).to(torch.int32)
    trace = torch.diagonal(sg.ob_quadric, dim1=-2, dim2=-1).sum(-1)
    # a plane is free when its LAST observation is in the window (the
    # reference's scatter keeps the last write per plane)
    plane_seen = index_set_last(
        torch.zeros((P,), dtype=torch.bool, device=dev),
        torch.where(ob_use, sg.ob_plane, P - 1).long(), ob_use)
    plane_fixed = ~(plane_seen & sg.pl_valid)

    R = sg.room_valid.shape[0]
    rw = torch.clamp(sg.room_walls, 0, P - 1)
    walls_ok = sg.room_walls >= 0
    is4 = sg.room_valid & torch.all(walls_ok, dim=1)
    is2 = sg.room_valid & walls_ok[:, 0] & walls_ok[:, 1] & ~is4
    room_idx = torch.arange(R, dtype=torch.int32, device=dev)
    room_fixed = ~(sg.room_valid & (is2 | is4))

    Dn = sg.door_valid.shape[0]
    door_fixed = ~sg.door_valid
    ddist = torch.linalg.norm(
        sg.door_pose[:, None, 4:7] - sg.room_center[None, :, :], dim=-1)
    ddist = torch.where(sg.room_valid[None, :], ddist, torch.inf)
    door_room_idx = torch.argmin(ddist, dim=1).to(torch.int32)
    has_room = torch.isfinite(torch.amin(ddist, dim=1))
    fac = SgFactors(
        ob_idx=ob_idx, ob_coeffs=sg.ob_coeffs,
        ob_info=torch.clamp(sg.ob_conf, min=0.1),
        ob_valid=ob_use & config.plane_kf_factor,
        ob_quadric=sg.ob_quadric,
        quad_info=torch.full(sg.ob_kf.shape, config.plane_point_info,
                             dtype=torch.float32, device=dev),
        quad_valid=ob_use & (trace > 1e-6) & config.plane_point_factor,
        room_idx=torch.cat([room_idx[:, None], rw], dim=1).to(torch.int32),
        room_info=torch.full((R,), config.room_info, dtype=torch.float32,
                             device=dev),
        room4_valid=is4 & config.room_factor,
        room2_valid=is2 & config.room_factor,
        door_idx=torch.stack([torch.arange(Dn, dtype=torch.int32,
                                           device=dev), door_room_idx],
                             dim=1),
        door_rel=sg.door_pose[:, 4:7]
        - sg.room_center[door_room_idx.long()],
        door_info=torch.ones((Dn,), dtype=torch.float32, device=dev),
        door_valid=sg.door_valid & has_room & config.door_factor)
    return fac, plane_fixed, room_fixed, door_fixed


def sg_factor_batches(fac: SgFactors) -> list:
    """The five ``FactorBatch``es of ``fac`` for the generic
    linearisation (K21's twin)."""
    h = SG_HUBER
    return [
        FactorBatch(("kf", "plane"), factors_mod.plane_kf, 3, fac.ob_idx,
                    {"pi_obs": fac.ob_coeffs}, fac.ob_info, fac.ob_valid,
                    huber=h[0]),
        FactorBatch(("kf", "plane"), factors_mod.plane_quadric, 1,
                    fac.ob_idx, {"G": fac.ob_quadric}, fac.quad_info,
                    fac.quad_valid, huber=h[1]),
        FactorBatch(("room", "plane", "plane", "plane", "plane"),
                    factors_mod.room_4wall, 3, fac.room_idx, {},
                    fac.room_info, fac.room4_valid, huber=h[2]),
        FactorBatch(("room", "plane", "plane"), factors_mod.room_2wall, 3,
                    fac.room_idx[:, :3], {}, fac.room_info, fac.room2_valid,
                    huber=h[3]),
        FactorBatch(("door", "room"), factors_mod.door_room, 3, fac.door_idx,
                    {"rel": fac.door_rel}, fac.door_info, fac.door_valid,
                    huber=h[4]),
    ]


def sg_assemble_torch(poses, planes, rooms, doors, fac: SgFactors):
    """The scene-graph factors' normal equations in plain torch (K21's
    twin, ``sg_system_torch``, adds the keyframe block): the five factor
    types linearised generically (``graph.linearize_batch``, forward-mode
    AD through each family's retraction) and scattered densely
    (``_assemble_dense``).  Returns (H (D, D), g (D,)) over [kf (L, 6) |
    plane (P, 3) | room (R, 3) | door (Dn, 6)], in the dtype of the
    values."""
    if poses.is_cuda:
        sg_assemble_torch.cuda_calls += 1
    problem = GraphProblem(
        families={"kf": se3_family(poses), "plane": plane_family(planes),
                  "room": point_family(rooms), "door": se3_family(doors)},
        factors=sg_factor_batches(fac))
    return _assemble_dense(problem, {"kf": poses, "plane": planes,
                                     "room": rooms, "door": doors})


sg_assemble_torch.cuda_calls = 0


class SgPlan(NamedTuple):
    """K21's plan of one scene-graph BA call (``sg_plan``), constant over
    its iterations.  Items are numbered [plane_kf Q | quadric Q | room4 R |
    room2 R | door Dn], variables [kf L | plane P | room R | door Dn]
    (V of them); a contributor code n * 25 + si * 5 + sj is live item n's
    slots si and sj.  Past the counts the lists hold -1."""

    live: torch.Tensor  # (NI,) int32 live items in item order
    pairs: torch.Tensor  # (np_cap,) int32 coupled pairs a * V + b, a <= b
    pptr: torch.Tensor  # (np_cap + 1,) int32 first contributor of a pair
    pent: torch.Tensor  # (ne_cap,) int32 contributors, (n, si, sj) order
    epos: torch.Tensor  # (NI * 25,) int32 each contributor code's position
    pmap: torch.Tensor  # (V, V) bool pairs some item couples
    rot: torch.Tensor  # (Q, 9) float64 each observation's chart rotation
    meta: torch.Tensor  # (2,) int32 [live items, coupled pairs]
    # scratch of the system launch, by contributor position: its block of
    # w J^T J (6 x 6 at most) and, on a diagonal pair, of w J^T r
    M: torch.Tensor | None  # (ne_cap, 36) float64
    G: torch.Tensor | None  # (ne_cap, 6) float64


def sg_plan_sizes(L: int, P: int, R: int, Dn: int, Q: int):
    """(NI, V, np_cap, ne_cap): items, variables, and the capacities of
    the coupled pairs (each item couples at most ns (ns + 1) / 2 of them)
    and of their contributors (ns^2 an item)."""
    NI, V = 2 * Q + 2 * R + Dn, L + P + R + Dn
    return (NI, V, min(V * (V + 1) // 2, 6 * Q + 21 * R + 3 * Dn),
            8 * Q + 34 * R + 4 * Dn)


def _slot_vars(fac: SgFactors, L: int, P: int) -> torch.Tensor:
    """(NI, 5) the variable of each item's slots, -1 past its slots."""
    ob, rm, dr = (fac.ob_idx.long(), fac.room_idx.long(),
                  fac.door_idx.long())
    R = rm.shape[0]

    def pad(v):
        return torch.cat([v, torch.full((v.shape[0], 5 - v.shape[1]), -1,
                                        dtype=v.dtype, device=v.device)], 1)

    kfpl = pad(torch.stack([ob[:, 0], L + ob[:, 1]], 1))
    room4 = torch.cat([L + P + rm[:, :1], L + rm[:, 1:]], 1)
    return torch.cat([kfpl, kfpl, room4, pad(room4[:, :3]), pad(torch.stack(
        [L + P + R + dr[:, 0], L + P + dr[:, 1]], 1))])


def sg_plan_torch(fac: SgFactors, L: int, P: int) -> SgPlan:
    """Plain twin of K21's plan: the live items, the coupled pairs and
    each one's contributors (every slot pair of a live item on variables
    a <= b, stably sorted by pair), the pair map and the observations'
    chart rotations.  ``M`` and ``G`` are None."""
    if fac.ob_idx.is_cuda:
        sg_plan_torch.cuda_calls += 1
    dev = fac.ob_idx.device
    Q, R, Dn = (fac.ob_idx.shape[0], fac.room_idx.shape[0],
                fac.door_idx.shape[0])
    NI, V, np_cap, ne_cap = sg_plan_sizes(L, P, R, Dn, Q)
    flags = torch.cat([fac.ob_valid, fac.quad_valid, fac.room4_valid,
                       fac.room2_valid, fac.door_valid])
    items = torch.nonzero(flags).flatten()
    n_live = items.shape[0]
    iv = _slot_vars(fac, L, P)[items]
    vi, vj = iv[:, :, None].expand(-1, 5, 5), iv[:, None, :].expand(-1, 5, 5)
    both = (vi >= 0) & (vj >= 0)
    k5 = torch.arange(5, device=dev)
    code = (torch.arange(n_live, device=dev)[:, None, None] * 25
            + k5[None, :, None] * 5 + k5[None, None, :])
    up = both & (vi <= vj)
    keys, order = torch.sort((vi * V + vj)[up], stable=True)
    pairs_u, counts = torch.unique_consecutive(keys, return_counts=True)
    n_pairs, n_ent = pairs_u.shape[0], keys.shape[0]

    def filled(n, head, fill):
        out = torch.full((n,), fill, dtype=torch.int32, device=dev)
        out[:head.shape[0]] = head
        return out

    pmap = torch.zeros((V * V,), dtype=torch.bool, device=dev)
    pmap[(vi * V + vj)[both]] = True
    pent = code[up][order]
    epos = torch.full((25 * NI,), -1, dtype=torch.int32, device=dev)
    epos[pent] = torch.arange(n_ent, dtype=torch.int32, device=dev)
    return SgPlan(
        live=filled(NI, items, -1), pairs=filled(np_cap, pairs_u, -1),
        pptr=filled(np_cap + 1, torch.cumsum(counts, 0) - counts, n_ent),
        pent=filled(ne_cap, pent, -1), epos=epos, pmap=pmap.reshape(V, V),
        rot=plane_mod.normal_rotation(
            fac.ob_coeffs[:, :3].double()).reshape(Q, 9),
        meta=torch.tensor([n_live, n_pairs], dtype=torch.int32, device=dev),
        M=None, G=None)


sg_plan_torch.cuda_calls = 0


def sg_plan(fac: SgFactors, L: int, P: int) -> SgPlan:
    """K21's plan of a BA call over ``L`` keyframes and ``P`` planes (one
    launch on CUDA tensors, with the system launch's scratch; the twin on
    CPU)."""
    if fac.ob_idx.device.type == "cpu":
        return sg_plan_torch(fac, L, P)
    cuda.require_cuda("sg_plan", *fac)
    Q, R, Dn = (fac.ob_idx.shape[0], fac.room_idx.shape[0],
                fac.door_idx.shape[0])
    NI, V, np_cap, ne_cap = sg_plan_sizes(L, P, R, Dn, Q)
    dev = fac.ob_idx.device

    def ints(n):
        return torch.empty((n,), dtype=torch.int32, device=dev)

    plan = SgPlan(
        live=ints(NI), pairs=ints(np_cap), pptr=ints(np_cap + 1),
        pent=ints(ne_cap), epos=ints(25 * NI),
        pmap=torch.empty((V, V), dtype=torch.bool, device=dev),
        rot=torch.empty((Q, 9), dtype=torch.float64, device=dev),
        meta=ints(2),
        M=torch.empty((ne_cap, 36), dtype=torch.float64, device=dev),
        G=torch.empty((ne_cap, 6), dtype=torch.float64, device=dev))
    ptr = cuda.ptr
    cuda.call("vsg_sg_plan", ptr(fac.ob_idx), ptr(fac.ob_coeffs),
              ptr(fac.ob_valid), ptr(fac.quad_valid), Q, ptr(fac.room_idx),
              ptr(fac.room4_valid), ptr(fac.room2_valid), R,
              ptr(fac.door_idx), ptr(fac.door_valid), Dn, L, P, np_cap,
              ne_cap, *map(ptr, plan[:8]), cuda.stream())
    sg_plan.launches += 1
    return plan


sg_plan.launches = 0


def sg_system_torch(poses, planes, rooms, doors, fac: SgFactors,
                    plan: SgPlan | None, S_kf, rhs_kf):
    """Plain twin of K21's system: ``sg_assemble_torch``'s H, g and the
    reference's S = H + S_kf on the keyframe block, rhs = [rhs_kf - g_kf |
    -g_rest] (fast_ba.py:388-389), in the dtype of the values; ``plan``
    is not read."""
    if poses.is_cuda:
        sg_system_torch.cuda_calls += 1
    H, g = sg_assemble_torch(poses, planes, rooms, doors, fac)
    kd = S_kf.shape[0]
    H[:kd, :kd] += S_kf.to(H.dtype)
    rhs = -g
    rhs[:kd] += rhs_kf.to(g.dtype)
    return H, rhs


sg_system_torch.cuda_calls = 0


def sg_system(poses, planes, rooms, doors, fac: SgFactors, plan: SgPlan,
              S_kf, rhs_kf):
    """A scene-graph BA iteration's reduced system (S, rhs): kernel K21,
    one launch over the call's ``plan`` on CUDA tensors, the twin on CPU;
    as ``sg_system_torch``."""
    if poses.device.type == "cpu":
        return sg_system_torch(poses, planes, rooms, doors, fac, plan, S_kf,
                               rhs_kf)
    if plan is None or plan.M is None:
        raise ValueError("sg_system: the call's plan (sg_plan) is required "
                         "on CUDA tensors")
    values = (poses, planes, rooms, doors)
    cuda.require_cuda("sg_system", *values, *fac, *plan, S_kf, rhs_kf)
    floats = values + (fac.ob_coeffs, fac.ob_info, fac.ob_quadric,
                       fac.quad_info, fac.room_info, fac.door_rel,
                       fac.door_info, S_kf, rhs_kf)
    if (any(t.dtype != torch.float32 for t in floats)
            or any(t.dtype != torch.int32
                   for t in (fac.ob_idx, fac.room_idx, fac.door_idx))):
        raise ValueError("sg_system: float32 values, int32 indices")
    L, P, R, Dn = (poses.shape[0], planes.shape[0], rooms.shape[0],
                   doors.shape[0])
    D = 6 * L + 3 * P + 3 * R + 6 * Dn
    if S_kf.shape != (6 * L, 6 * L) or rhs_kf.shape != (6 * L,):
        raise ValueError("sg_system: S_kf (6L, 6L) and rhs_kf (6L,)")
    S = torch.empty((D, D), dtype=torch.float32, device=poses.device)
    rhs = torch.empty((D,), dtype=torch.float32, device=poses.device)
    ptr = cuda.ptr
    cuda.call("vsg_sg_system", ptr(poses), L, ptr(planes), P, ptr(rooms),
              R, ptr(doors), Dn, ptr(fac.ob_idx), ptr(fac.ob_coeffs),
              ptr(fac.ob_info), ptr(fac.ob_quadric), ptr(fac.quad_info),
              fac.ob_idx.shape[0], ptr(fac.room_idx), ptr(fac.room_info),
              ptr(fac.door_idx), ptr(fac.door_rel), ptr(fac.door_info),
              *SG_HUBER, *map(ptr, plan), ptr(S_kf), ptr(rhs_kf), ptr(S),
              ptr(rhs), cuda.stream())
    sg_system.launches += 1
    return S, rhs


sg_system.launches = 0


def sg_assemble(poses, planes, rooms, doors, fac: SgFactors):
    """The scene-graph factors' dense normal equations H, g alone: K21's
    plan and system with a zero keyframe block on CUDA tensors (H = S, g =
    -rhs), the twin on CPU; as ``sg_assemble_torch``."""
    if poses.device.type == "cpu":
        return sg_assemble_torch(poses, planes, rooms, doors, fac)
    kd = 6 * poses.shape[0]
    S, rhs = sg_system(
        poses, planes, rooms, doors, fac,
        sg_plan(fac, poses.shape[0], planes.shape[0]),
        torch.zeros((kd, kd), dtype=torch.float32, device=poses.device),
        torch.zeros((kd,), dtype=torch.float32, device=poses.device))
    return S, -rhs


def fast_scenegraph_ba(m: MapState, sg, kf_id: int, cam_K: torch.Tensor,
                       cam_bf: torch.Tensor, n_window: int = 10,
                       n_local_pts: int = 8192, max_obs: int = 12,
                       iters: int = 8, lam: float = 1e-4,
                       config: SceneGraphConfig | None = None,
                       system=None):
    """Analytic LBA with the scene-graph families in the same reduced
    solve: landmarks reduce per landmark (K8); plane-KF, Gij-quadric, room
    and door factors are linearised and assembled densely into the same
    system, with the landmarks' keyframe block added (K21, ``system``,
    over a plan made once a call; None: ``sg_system``, ``sg_system_torch``
    forces the twin), so planes still pull keyframe poses.  Returns (map,
    scenegraph, final cost)."""
    config = config or SceneGraphConfig()
    system = system or sg_system
    dev = m.kf_pose.device
    if m.kf_pose.is_cuda:
        fast_scenegraph_ba.cuda_calls += 1
        fast_scenegraph_ba.cuda_iters += iters
    counts = covisibility_counts(m, kf_id).to(torch.float32)
    if config.plane_covis_enabled:
        # shared planes boost the pair weight before the window is picked
        counts = counts + plane_covis_bonus(
            sg, kf_id, m.K, min_votes=config.plane_min_votes,
            score=config.plane_covis_score,
            undefined_factor=config.plane_covis_undefined_factor,
        ) * torch.where(m.kf_valid, 1.0, 0.0)
    kf_ids, kf_mask = _window(m, kf_id, counts, n_window)
    L = kf_ids.shape[0]
    safe_pt, pt_ok, kf_tab, uvr_tab, val_tab, bf = _observation_tables(
        m, kf_ids, kf_mask, cam_bf, n_local_pts, max_obs)
    min_id = torch.min(torch.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)

    kf_inv = index_set_last(
        torch.full((m.K,), -1, dtype=torch.int32, device=dev), kf_ids,
        torch.where(kf_mask, torch.arange(L, dtype=torch.int32, device=dev),
                    -1))
    ob_local_kf = kf_inv[torch.clamp(sg.ob_kf, 0, m.K - 1).long()]
    fac, plane_fixed, room_fixed, door_fixed = _scenegraph_factors(
        sg, ob_local_kf, config)
    P, R, Dn = sg.P, sg.room_valid.shape[0], sg.door_valid.shape[0]
    kf_dim = 6 * L
    free = torch.cat([
        (~kf_fixed).repeat_interleave(6), (~plane_fixed).repeat_interleave(3),
        (~room_fixed).repeat_interleave(3), (~door_fixed).repeat_interleave(6),
    ]).to(torch.float32)

    poses, pts = m.kf_pose[kf_ids], m.pt_pos[safe_pt]
    planes, rooms, doors = (sg.pl_coeffs.contiguous(),
                            sg.room_center.contiguous(),
                            sg.door_pose.contiguous())
    plan = sg_plan(fac, L, P)
    cost = None
    for _ in range(iters):
        S_kf, rhs_kf, Hinv, bx, W, cost = local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, 2.45)
        S, rhs = system(poses, planes, rooms, doors, fac, plan, S_kf,
                        rhs_kf)
        dx, poses, planes, rooms, doors = ba_solve(S, rhs, free, lam, poses,
                                                   planes, rooms, doors)
        pts = back_substitute(Hinv, bx, W, kf_tab, val_tab,
                              dx[:kf_dim].view(L, 6), pts, pt_ok)
    m = _write_back(m, kf_ids, kf_mask, kf_fixed, poses, safe_pt, pt_ok, pts)
    planes = planes / torch.clamp(
        torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True), min=1e-9)
    sg = sg._replace(
        pl_coeffs=torch.where(plane_fixed[:, None], sg.pl_coeffs, planes),
        room_center=torch.where(room_fixed[:, None], sg.room_center, rooms),
        door_pose=torch.where(door_fixed[:, None], sg.door_pose, doors))
    return m, sg, cost


# calls and iterations on the card (K21's plan launches once a call, its
# system once an iteration)
fast_scenegraph_ba.cuda_calls = 0
fast_scenegraph_ba.cuda_iters = 0
