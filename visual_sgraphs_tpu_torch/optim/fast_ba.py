"""Analytic windowed bundle adjustment — the keyframe path's local BA.

Port of ``fast_local_ba`` and ``fast_scenegraph_ba`` from
``visual_sgraphs_tpu/optim/fast_ba.py`` (Optimizer::LocalBundleAdjustment,
Optimizer.cc:1454, with the vS-Graphs plane / room / door blocks of
Optimizer.cc:2049-2260): the reference keyframe plus its ``n_window`` most
covisible keyframes and every valid point they observe; the oldest local
keyframe (and keyframe 0) is the gauge anchor.  Each Gauss-Newton
iteration reduces the landmarks with the Schur kernel K8
(``parallel/dist_ba.py``), adds the scene-graph factor blocks (linearised
generically, ``optim/graph.py``) as dense rows of the same system, solves
it by Cholesky and back-substitutes the points.

Layout of the reduced tangent vector of the scene-graph variant:
    [ kf (L, 6) | plane (P, 3) | room (R, 3) | door (D, 6) ]
"""

from __future__ import annotations

import dataclasses

import torch

from visual_sgraphs_tpu_torch.config import SceneGraphConfig
from visual_sgraphs_tpu_torch.core import lie
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
    group_observations,
    local_reduced_system,
    solve_damped,
)
from visual_sgraphs_tpu_torch.scenegraph.manager import plane_covis_bonus
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    compact_true,
    covisibility_counts,
    index_set_last,
    observed_mask,
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
    local_pt = compact_true(observed_mask(m, kf_ids, kf_mask) & m.pt_valid,
                            n_local_pts)
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
    for _ in range(iters):
        S, rhs, Hinv, bx, W, cost = local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, 2.45)
        dxr6 = solve_damped(S, rhs, free, lam).reshape(L, 6)
        new_poses = lie.se3_normalize(lie.se3_boxplus(
            poses, torch.where(kf_fixed[:, None], 0.0, dxr6)))
        dxe = back_substitute(Hinv, bx, W, kf_tab, val_tab, dxr6)
        pts = pts + torch.where(pt_ok[:, None], dxe, 0.0)
        poses = new_poses
    return _write_back(m, kf_ids, kf_mask, kf_fixed, poses, safe_pt, pt_ok,
                       pts), cost


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


def _scenegraph_batches(sg, ob_local_kf, config: SceneGraphConfig):
    """The plane-KF, Gij-quadric, room and door factor batches and the
    fixed masks of the plane / room / door families."""
    P = sg.P
    dev = sg.pl_coeffs.device
    ob_use = sg.ob_valid & (sg.ob_plane >= 0) & (ob_local_kf >= 0)
    plane_var_idx = torch.stack([torch.clamp(ob_local_kf, min=0),
                                 torch.clamp(sg.ob_plane, min=0)],
                                dim=1).to(torch.int32)
    batches = []
    if config.plane_kf_factor:
        batches.append(FactorBatch(
            ("kf", "plane"), factors_mod.plane_kf, 3, plane_var_idx,
            {"pi_obs": sg.ob_coeffs}, torch.clamp(sg.ob_conf, min=0.1),
            ob_use, huber=2.79))
    if config.plane_point_factor:
        trace = torch.diagonal(sg.ob_quadric, dim1=-2, dim2=-1).sum(-1)
        batches.append(FactorBatch(
            ("kf", "plane"), factors_mod.plane_quadric, 1, plane_var_idx,
            {"G": sg.ob_quadric},
            torch.full(sg.ob_kf.shape, config.plane_point_info,
                       dtype=torch.float32, device=dev),
            ob_use & (trace > 1e-6), huber=1.96))
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
    if config.room_factor:
        info = torch.full((R,), config.room_info, dtype=torch.float32,
                          device=dev)
        batches.append(FactorBatch(
            ("room", "plane", "plane", "plane", "plane"),
            factors_mod.room_4wall, 3,
            torch.cat([room_idx[:, None], rw], dim=1), {}, info, is4,
            huber=1.0))
        batches.append(FactorBatch(
            ("room", "plane", "plane"), factors_mod.room_2wall, 3,
            torch.cat([room_idx[:, None], rw[:, :2]], dim=1), {}, info, is2,
            huber=1.0))
    room_fixed = ~(sg.room_valid & (is2 | is4))

    Dn = sg.door_valid.shape[0]
    door_fixed = ~sg.door_valid
    if config.door_factor:
        ddist = torch.linalg.norm(
            sg.door_pose[:, None, 4:7] - sg.room_center[None, :, :], dim=-1)
        ddist = torch.where(sg.room_valid[None, :], ddist, torch.inf)
        door_room_idx = torch.argmin(ddist, dim=1).to(torch.int32)
        has_room = torch.isfinite(torch.amin(ddist, dim=1))
        rel = sg.door_pose[:, 4:7] - sg.room_center[door_room_idx.long()]
        batches.append(FactorBatch(
            ("door", "room"), factors_mod.door_room, 3,
            torch.stack([torch.arange(Dn, dtype=torch.int32, device=dev),
                         door_room_idx], dim=1),
            {"rel": rel}, torch.ones((Dn,), dtype=torch.float32, device=dev),
            sg.door_valid & has_room, huber=1.0))
    return batches, plane_fixed, room_fixed, door_fixed


def fast_scenegraph_ba(m: MapState, sg, kf_id: int, cam_K: torch.Tensor,
                       cam_bf: torch.Tensor, n_window: int = 10,
                       n_local_pts: int = 8192, max_obs: int = 12,
                       iters: int = 8, lam: float = 1e-4,
                       config: SceneGraphConfig | None = None):
    """Analytic LBA with the scene-graph families in the same reduced
    solve: landmarks reduce per landmark (K8); plane-KF, Gij-quadric, room
    and door factors are linearised generically and added as dense rows,
    so planes still pull keyframe poses.  Returns (map, scenegraph, final
    cost)."""
    config = config or SceneGraphConfig()
    dev = m.kf_pose.device
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
    batches, plane_fixed, room_fixed, door_fixed = _scenegraph_batches(
        sg, ob_local_kf, config)
    P, R, Dn = sg.P, sg.room_valid.shape[0], sg.door_valid.shape[0]
    kf_dim = 6 * L
    free = torch.cat([
        (~kf_fixed).repeat_interleave(6), (~plane_fixed).repeat_interleave(3),
        (~room_fixed).repeat_interleave(3), (~door_fixed).repeat_interleave(6),
    ]).to(torch.float32)

    poses, pts = m.kf_pose[kf_ids], m.pt_pos[safe_pt]
    planes, rooms, doors = sg.pl_coeffs, sg.room_center, sg.door_pose
    cost = None
    for _ in range(iters):
        S_kf, rhs_kf, Hinv, bx, W, cost = local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, 2.45)
        problem = GraphProblem(
            families={"kf": se3_family(poses, kf_fixed),
                      "plane": plane_family(planes, plane_fixed),
                      "room": point_family(rooms, room_fixed),
                      "door": se3_family(doors, door_fixed)},
            factors=batches)
        S, g = _assemble_dense(problem, {"kf": poses, "plane": planes,
                                         "room": rooms, "door": doors})
        S[:kf_dim, :kf_dim] += S_kf
        rhs = -g
        rhs[:kf_dim] += rhs_kf
        dx = solve_damped(S, rhs, free, lam)
        dkf = dx[:kf_dim].reshape(L, 6)
        off = kf_dim
        dpl = dx[off:off + 3 * P].reshape(P, 3)
        off += 3 * P
        drm = dx[off:off + 3 * R].reshape(R, 3)
        off += 3 * R
        ddr = dx[off:off + 6 * Dn].reshape(Dn, 6)
        new_poses = lie.se3_normalize(lie.se3_boxplus(
            poses, torch.where(kf_fixed[:, None], 0.0, dkf)))
        planes = plane_mod.oplus(
            planes, torch.where(plane_fixed[:, None], 0.0, dpl))
        rooms = rooms + torch.where(room_fixed[:, None], 0.0, drm)
        doors = lie.se3_normalize(lie.se3_boxplus(
            doors, torch.where(door_fixed[:, None], 0.0, ddr)))
        dxe = back_substitute(Hinv, bx, W, kf_tab, val_tab, dkf)
        pts = pts + torch.where(pt_ok[:, None], dxe, 0.0)
        poses = new_poses
    m = _write_back(m, kf_ids, kf_mask, kf_fixed, poses, safe_pt, pt_ok, pts)
    planes = planes / torch.clamp(
        torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True), min=1e-9)
    sg = sg._replace(
        pl_coeffs=torch.where(plane_fixed[:, None], sg.pl_coeffs, planes),
        room_center=torch.where(room_fixed[:, None], sg.room_center, rooms),
        door_pose=torch.where(door_fixed[:, None], sg.door_pose, doors))
    return m, sg, cost
