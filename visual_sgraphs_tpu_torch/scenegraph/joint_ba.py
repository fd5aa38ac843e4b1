"""Joint scene-graph bundle adjustment on the generic LM engine: keyframes
+ points + planes + rooms + doors.

Port of ``visual_sgraphs_tpu/scenegraph/joint_ba.py`` (the vS-Graphs
extension of Optimizer::LocalBundleAdjustment, Optimizer.cc:1454-2455),
which the recovery keyframe runs: the visual window of
``slam/mapping.py::local_ba`` plus plane-KF observation factors,
plane-point quadric factors, point-on-plane factors, room-center factors
and door-room factors, in one LM solve with the points eliminated
(``optim/solve.py``).  After the solve, plane observations whose plane-KF
chi2 exceeds four times the gate are erased (Optimizer.cc:2344-2370).
"""

from __future__ import annotations

import math

import torch

from visual_sgraphs_tpu_torch.config import SceneGraphConfig
from visual_sgraphs_tpu_torch.optim import factors
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    batch_chi2,
    plane_family,
    point_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.optim.solve import optimize
from visual_sgraphs_tpu_torch.scenegraph.state import SceneGraphState
from visual_sgraphs_tpu_torch.slam.map_state import MapState, index_set_last
from visual_sgraphs_tpu_torch.slam.mapping import (
    lba_gauge,
    lba_window,
    write_window,
)

CHI2_PLANE = 7.815  # plane-KF gate (Optimizer.cc:2344)
CHI2_PLANE_POINT = 3.841  # plane-point gate (Optimizer.cc:2357)


def scenegraph_local_ba(m: MapState, sg: SceneGraphState, kf_id: int,
                        cam_K, cam_bf, plane_info=None, n_window: int = 10,
                        n_local_pts: int = 8192, iters: int = 10,
                        config: SceneGraphConfig = SceneGraphConfig()):
    """Local BA with plane / room / door variables and the vS-Graphs
    factor set.  Planes observed by a window keyframe are free, the rest
    fixed.  Returns (map, scenegraph, final cost as a device scalar)."""
    dev = m.kf_pose.device
    if plane_info is None:
        plane_info = torch.ones((), dtype=torch.float32, device=dev)
    kf_ids, kf_mask, safe_pt, pt_ok, batches = lba_window(
        m, kf_id, cam_K, cam_bf, n_window, n_local_pts)
    L = kf_ids.shape[0]
    P = sg.P

    # plane-KF observation factors over the window's keyframes
    kf_inv = index_set_last(
        torch.full((m.K,), -1, dtype=torch.int32, device=dev), kf_ids,
        torch.where(kf_mask, torch.arange(L, dtype=torch.int32, device=dev),
                    -1))
    ob_local_kf = kf_inv[torch.clamp(sg.ob_kf, 0, m.K - 1).long()]
    ob_use = sg.ob_valid & (sg.ob_plane >= 0) & (ob_local_kf >= 0)
    plane_var_idx = torch.stack([torch.clamp(ob_local_kf, min=0),
                                 torch.clamp(sg.ob_plane, min=0)],
                                dim=1).to(torch.int32)
    n_ob = sg.ob_kf.shape[0]
    plane_kf_batch = None
    if config.plane_kf_factor:
        plane_kf_batch = FactorBatch(
            ("kf", "plane"), factors.plane_kf, 3, plane_var_idx,
            {"pi_obs": sg.ob_coeffs},
            plane_info * torch.clamp(sg.ob_conf, min=0.1), ob_use,
            huber=math.sqrt(CHI2_PLANE))
        batches.append(plane_kf_batch)
    if config.plane_point_factor:
        trace = torch.diagonal(sg.ob_quadric, dim1=-2, dim2=-1).sum(-1)
        batches.append(FactorBatch(
            ("kf", "plane"), factors.plane_quadric, 1, plane_var_idx,
            {"G": sg.ob_quadric},
            plane_info * torch.full((n_ob,), config.plane_point_info,
                                    dtype=torch.float32, device=dev),
            ob_use & (trace > 1e-6), huber=math.sqrt(CHI2_PLANE_POINT)))
    if config.plane_map_point_factor:
        # local map points near a valid plane's surface and centroid
        # (octree membership, Plane.cc:81-140)
        p_local = m.pt_pos[safe_pt]
        pd = torch.abs(torch.einsum("pi,ni->pn", sg.pl_coeffs[:, :3],
                                    p_local) + sg.pl_coeffs[:, 3:4])
        cd = torch.linalg.norm(p_local[None, :, :]
                               - sg.pl_centroid[:, None, :], dim=-1)
        onpl = (pd < config.plane_map_point_dist) & (cd < 3.0) \
            & sg.pl_valid[:, None]
        best_plane = torch.argmin(torch.where(onpl, pd, torch.inf),
                                  dim=0).to(torch.int32)
        pt_on = pt_ok & torch.any(onpl, dim=0)
        batches.append(FactorBatch(
            ("plane", "pt"), factors.point_on_plane, 1,
            torch.stack([best_plane, torch.arange(
                n_local_pts, dtype=torch.int32, device=dev)], dim=1), {},
            plane_info * torch.full((n_local_pts,),
                                    config.plane_map_point_info,
                                    dtype=torch.float32, device=dev),
            pt_on, huber=math.sqrt(CHI2_PLANE_POINT)))

    # a plane is free when its last observation lies in the window (the
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
            ("room", "plane", "plane", "plane", "plane"), factors.room_4wall,
            3, torch.cat([room_idx[:, None], rw], dim=1), {}, info, is4,
            huber=1.0))
        batches.append(FactorBatch(
            ("room", "plane", "plane"), factors.room_2wall, 3,
            torch.cat([room_idx[:, None], rw[:, :2]], dim=1), {}, info, is2,
            huber=1.0))
    room_fixed = ~(sg.room_valid & (is2 | is4))

    Dn = sg.door_valid.shape[0]
    door_fixed = ~sg.door_valid
    if config.door_factor:
        # nearest valid room per door
        ddist = torch.linalg.norm(
            sg.door_pose[:, None, 4:7] - sg.room_center[None, :, :], dim=-1)
        ddist = torch.where(sg.room_valid[None, :], ddist, torch.inf)
        door_room_idx = torch.argmin(ddist, dim=1).to(torch.int32)
        has_room = torch.isfinite(torch.amin(ddist, dim=1))
        rel = sg.door_pose[:, 4:7] - sg.room_center[door_room_idx.long()]
        batches.append(FactorBatch(
            ("door", "room"), factors.door_room, 3,
            torch.stack([torch.arange(Dn, dtype=torch.int32, device=dev),
                         door_room_idx], dim=1),
            {"rel": rel}, torch.ones((Dn,), dtype=torch.float32, device=dev),
            sg.door_valid & has_room, huber=1.0))

    kf_fixed = lba_gauge(m, kf_ids, kf_mask, False)
    problem = GraphProblem(
        families={"kf": se3_family(m.kf_pose[kf_ids], kf_fixed),
                  "pt": point_family(m.pt_pos[safe_pt], ~pt_ok),
                  "plane": plane_family(sg.pl_coeffs, plane_fixed),
                  "room": point_family(sg.room_center, room_fixed),
                  "door": se3_family(sg.door_pose, door_fixed)},
        factors=batches, eliminated="pt")
    res = optimize(problem, iters=iters)

    m = write_window(m, kf_ids, kf_mask, res.values["kf"], safe_pt, pt_ok,
                     res.values["pt"])
    planes = torch.where(plane_fixed[:, None], sg.pl_coeffs,
                         res.values["plane"])
    planes = planes / torch.clamp(
        torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True), min=1e-9)
    rooms = torch.where(room_fixed[:, None], sg.room_center,
                        res.values["room"])
    doors = torch.where(door_fixed[:, None], sg.door_pose,
                        res.values["door"])
    ob_valid = sg.ob_valid
    if config.plane_kf_factor:
        chi2 = batch_chi2(plane_kf_batch, {
            "kf": se3_family(m.kf_pose[kf_ids], kf_fixed),
            "plane": plane_family(planes, plane_fixed)})
        ob_valid = ob_valid & torch.where(ob_use, chi2 <= CHI2_PLANE * 4.0,
                                          True)
    return m, sg._replace(pl_coeffs=planes, room_center=rooms,
                          door_pose=doors, ob_valid=ob_valid), res.cost
