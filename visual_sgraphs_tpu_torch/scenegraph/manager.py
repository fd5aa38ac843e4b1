"""Scene-graph manager: the per-keyframe plane pipeline and room inference.

Port of ``visual_sgraphs_tpu/scenegraph/manager.py`` (GeometricSegmentation
+ SemanticSegmentation + SemanticsManager of vS-Graphs as functions over
``SceneGraphState``):

- ``detect_planes_from_depth``: depth -> strided cloud -> voxel downsample
  (K12) -> weighted RANSAC (K13) -> per-detection statistics (K14);
- ``associate_and_update`` (kernel K24, ``csrc/plane_assoc.cu``):
  chart-distance association against the plane table, running-average
  update or creation, observation records;
- ``filter_semantic_planes`` / ``reassociate_planes``: the periodic
  maintenance; ``detect_rooms`` (kernel K23, ``csrc/rooms.cu``): corridor
  / room candidates from facing walls; ``refine_points_semantic``: culls
  map points behind settled planes; ``plane_covis_bonus``: plane-based
  covisibility weights;
``SceneGraphManager.update_freespace`` / ``infer_rooms_freespace``: the
free-space room method (``room_method="freespace"``, ``freespace.py``).

Every function is sync-free on the device: scalar selections use one-
element index tensors (indexing with a 0-d CUDA tensor reads it back to
the host).  Each kernel's wrapper launches it on CUDA tensors (counting
the launch in ``wrapper.launches``) and takes its plain twin only for CPU
tensors (the twin counts calls on CUDA tensors in ``twin.cuda_calls``).
Not ported: ``observe_markers`` (no caller in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.config import CapacityConfig, SceneGraphConfig
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.core import plane as plane_mod
from visual_sgraphs_tpu_torch.cuda import resolve_device
from visual_sgraphs_tpu_torch.scenegraph.epilogue import (
    member_threshold,
    plane_epilogue,
)
from visual_sgraphs_tpu_torch.scenegraph.plane_fit import extract_planes
from visual_sgraphs_tpu_torch.scenegraph.pointcloud import depth_cloud
from visual_sgraphs_tpu_torch.scenegraph.state import (
    GROUND,
    UNDEFINED,
    WALL,
    SceneGraphState,
    empty_scenegraph,
    plane_semantics,
    voxel_key,
    voxel_slot,
)
from visual_sgraphs_tpu_torch.slam.map_state import index_set_last


def _idx(i: torch.Tensor) -> torch.Tensor:
    return i.reshape(1).long()


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without a host read."""
    return x.index_select(0, _idx(i))[0]


def _put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``x.at[i].set(v)``."""
    v = v.to(x.dtype)
    return x.index_copy(0, _idx(i), v.expand(x.shape[1:]).unsqueeze(0))


def _add(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``x.at[i].add(v)``."""
    v = v.to(x.dtype)
    return x.index_add(0, _idx(i), v.expand(x.shape[1:]).unsqueeze(0))


# ---------------------------------------------------------------------------
# per-keyframe plane detection and association
# ---------------------------------------------------------------------------


def detect_planes_from_depth(depth_img, sem_img, T_cw, cam_K, hyp_idx,
                             conf_img=None, n_cloud: int = 2048,
                             voxel: float = 0.08, dist_thresh: float = 0.04,
                             min_inliers: float = 150.0,
                             vox_slots: int = 512):
    """Depth (+ optional class / confidence images) -> detected planes.

    ``hyp_idx``: (n_det, n_hyp, 3) int32 RANSAC samples into the
    ``n_cloud``-point downsampled cloud.  Returns (world_coeffs (n_det, 4),
    valid, centroid (n_det, 3), npts, votes (n_det, N_CLASSES),
    local_coeffs (n_det, 4), quadric (n_det, 4, 4), det_vox (n_det, V))."""
    pts, valid, labels, conf, cloud, cvalid, cweight = depth_cloud(
        depth_img, sem_img, conf_img, cam_K, voxel, n_cloud)
    coeffs_c, det_valid, _ = extract_planes(
        cloud, cvalid, cweight, hyp_idx, dist_thresh=dist_thresh,
        min_inliers=min_inliers)
    T_wc = lie.se3_inverse(T_cw)
    coeffs_w = plane_mod.transform(T_wc, coeffs_c)
    npts, centroid, votes, quad, det_vox = plane_epilogue(
        pts, valid, labels, conf, coeffs_c, coeffs_w, T_wc,
        member_threshold(dist_thresh), vox_slots)
    return (coeffs_w, det_valid, centroid, npts, votes, coeffs_c, quad,
            det_vox)


def associate_and_update_torch(sg: SceneGraphState, det_coeffs, det_valid,
                               det_centroid, det_npts, det_votes, det_local,
                               kf_id: int, det_quadric=None, det_vox=None,
                               ominus_thresh: float = 0.3,
                               dist_thresh: float = 0.35,
                               centroid_thresh: float = 1.5
                               ) -> SceneGraphState:
    """Plain twin of K24 (reference ``manager.py:51``)."""
    if sg.pl_coeffs.is_cuda:
        associate_and_update_torch.cuda_calls += 1
    dt = sg.pl_coeffs.dtype
    dev = sg.pl_coeffs.device
    det_coeffs, det_centroid = det_coeffs.to(dt), det_centroid.to(dt)
    det_npts, det_votes = det_npts.to(dt), det_votes.to(dt)
    det_local = det_local.to(dt)
    n_det = det_coeffs.shape[0]
    if det_quadric is None:
        det_quadric = torch.zeros((n_det, 4, 4), dtype=dt, device=dev)
    det_quadric = det_quadric.to(dt)
    P = sg.P
    Q = sg.ob_kf.shape[0]
    s = sg._asdict()
    for i in range(n_det):
        coeffs, ok = det_coeffs[i], det_valid[i]
        diff = plane_mod.ominus(s["pl_coeffs"], coeffs[None])  # (P, 3)
        ang = torch.linalg.norm(diff[:, :2], dim=-1)
        dd = torch.abs(diff[:, 2])
        cdist = torch.linalg.norm(s["pl_centroid"] - det_centroid[i], dim=-1)
        cand = (s["pl_valid"] & (ang < ominus_thresh) & (dd < dist_thresh)
                & (cdist < centroid_thresh))
        score = torch.where(cand, ang + dd, torch.inf)
        best = torch.argmin(score)
        matched = ok & torch.isfinite(_take(score, best))

        # update the matched plane: running weighted average in the chart
        # of the old plane, vote accumulation
        w_old = torch.clamp(_take(s["pl_npts"], best), min=1.0)
        w_new = torch.clamp(det_npts[i], min=1.0)
        alpha = w_new / (w_old + w_new)
        old = _take(s["pl_coeffs"], best)
        blended = plane_mod.oplus(old, alpha * plane_mod.ominus(old, coeffs))
        old_c = _take(s["pl_centroid"], best)
        s["pl_coeffs"] = _put(s["pl_coeffs"], best,
                              torch.where(matched, blended, old))
        s["pl_centroid"] = _put(s["pl_centroid"], best, torch.where(
            matched, old_c * (1 - alpha) + det_centroid[i] * alpha, old_c))
        s["pl_npts"] = _add(s["pl_npts"], best,
                            torch.where(matched, det_npts[i], 0.0))
        s["pl_votes"] = _add(s["pl_votes"], best,
                             torch.where(matched, det_votes[i], 0.0))
        s["pl_nobs"] = _add(s["pl_nobs"], best, matched.to(torch.int32))

        # or create a new plane
        n_pl = s["n_planes"]
        slot = torch.clamp(n_pl, max=P - 1)
        can_alloc = ok & ~matched & (n_pl < P)
        s["pl_coeffs"] = _put(s["pl_coeffs"], slot, torch.where(
            can_alloc, coeffs, _take(s["pl_coeffs"], slot)))
        s["pl_valid"] = _put(s["pl_valid"], slot,
                             can_alloc | _take(s["pl_valid"], slot))
        s["pl_centroid"] = _put(s["pl_centroid"], slot, torch.where(
            can_alloc, det_centroid[i], _take(s["pl_centroid"], slot)))
        s["pl_npts"] = _add(s["pl_npts"], slot,
                            torch.where(can_alloc, det_npts[i], 0.0))
        s["pl_votes"] = _add(s["pl_votes"], slot,
                             torch.where(can_alloc, det_votes[i], 0.0))
        s["pl_nobs"] = _add(s["pl_nobs"], slot, can_alloc.to(torch.int32))
        s["n_planes"] = n_pl + can_alloc.to(torch.int32)
        plane_id = torch.where(matched, best,
                               torch.where(can_alloc, slot, -1))

        # merge the detection's surface voxels into the plane's table
        if det_vox is not None:
            row = torch.clamp(plane_id, min=0)
            merged = torch.where((plane_id >= 0) & (det_vox[i] >= 0),
                                 det_vox[i], _take(s["pl_vox"], row))
            s["pl_vox"] = _put(s["pl_vox"], row, merged)

        # record the observation for the plane-KF factors
        n_ob = s["n_obs"]
        oslot = torch.clamp(n_ob, max=Q - 1)
        rec = (plane_id >= 0) & (n_ob < Q)
        conf = torch.sum(det_votes[i]) / torch.clamp(det_npts[i], min=1.0)
        # (the keyframe slot is filled on the device: a tensor made from a
        # host int is a synchronising copy)
        kf_t = torch.full((), kf_id, dtype=torch.int32, device=dev)
        for name, value in (("ob_kf", kf_t), ("ob_plane", plane_id),
                            ("ob_coeffs", det_local[i]), ("ob_conf", conf),
                            ("ob_quadric", det_quadric[i])):
            old_v = _take(s[name], oslot)
            s[name] = _put(s[name], oslot,
                           torch.where(rec, value.to(old_v.dtype), old_v))
        s["ob_valid"] = _put(s["ob_valid"], oslot,
                             rec | _take(s["ob_valid"], oslot))
        s["n_obs"] = n_ob + rec.to(torch.int32)
    return SceneGraphState(**s)


associate_and_update_torch.cuda_calls = 0

# the tables K24 reads and returns anew, in its pointer order, and their
# dtypes
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_ASSOC_TABLES = {"pl_coeffs": _F32, "pl_valid": _BOOL, "pl_centroid": _F32,
                 "pl_npts": _F32, "pl_votes": _F32, "pl_nobs": _I32,
                 "n_planes": _I32, "pl_vox": _I32, "ob_kf": _I32,
                 "ob_plane": _I32, "ob_coeffs": _F32, "ob_conf": _F32,
                 "ob_quadric": _F32, "ob_valid": _BOOL, "n_obs": _I32}


def associate_and_update(sg: SceneGraphState, det_coeffs, det_valid,
                         det_centroid, det_npts, det_votes, det_local,
                         kf_id: int, det_quadric=None, det_vox=None,
                         ominus_thresh: float = 0.3,
                         dist_thresh: float = 0.35,
                         centroid_thresh: float = 1.5) -> SceneGraphState:
    """Associate the detections ((n_det, 4) world planes, (n_det,) bool,
    (n_det, 3) centroids, (n_det,) support, (n_det, 3) votes, (n_det, 4)
    camera-frame planes, optional (n_det, 4, 4) quadrics and (n_det, V)
    voxel keys) with the plane table in turn; update matches, create the
    rest, record one observation per associated detection for keyframe
    ``kf_id`` (Utils::associatePlanes + GeoSemHelpers::create/
    updateMapPlane).  Kernel K24 on CUDA tensors, the twin on CPU."""
    if sg.pl_coeffs.device.type == "cpu":
        return associate_and_update_torch(
            sg, det_coeffs, det_valid, det_centroid, det_npts, det_votes,
            det_local, kf_id, det_quadric, det_vox, ominus_thresh,
            dist_thresh, centroid_thresh)
    tables = [getattr(sg, k) for k in _ASSOC_TABLES]
    dets = [det_coeffs, det_valid, det_centroid, det_npts, det_votes,
            det_local, det_quadric, det_vox]
    cuda.require_cuda("associate_and_update", *tables,
                      *(d for d in dets if d is not None))
    n_det, (P, V), Q = det_coeffs.shape[0], sg.pl_vox.shape, sg.ob_kf.shape[0]
    shapes = ((n_det, 4), (n_det,), (n_det, 3), (n_det,), (n_det, 3),
              (n_det, 4), (n_det, 4, 4), (n_det, V))
    dtypes = (_F32, _BOOL) + (_F32,) * 5 + (_I32,)
    if (any(d is not None and (tuple(d.shape) != sh or d.dtype != dt)
            for d, sh, dt in zip(dets, shapes, dtypes))
            or any(t.dtype != dt for t, dt in zip(
                tables, _ASSOC_TABLES.values()))):
        raise ValueError("associate_and_update: the state's dtypes and "
                         f"detections of shapes {shapes} in float32 (bool "
                         "valid, int32 voxels)")
    if P > 128 or V > 512 or n_det > 16:
        raise ValueError("associate_and_update: P <= 128, V <= 512, "
                         "n_det <= 16")
    outs = [torch.empty_like(t) for t in tables]
    cuda.call("vsg_plane_assoc", cuda.ptr_array(tables),
              cuda.ptr_array(outs), cuda.ptr_array(dets), n_det, P, V, Q,
              int(kf_id), float(ominus_thresh), float(dist_thresh),
              float(centroid_thresh), cuda.stream())
    associate_and_update.launches += 1
    return sg._replace(**dict(zip(_ASSOC_TABLES, outs)))


associate_and_update.launches = 0


# ---------------------------------------------------------------------------
# rooms, refinement, covisibility and maintenance
# ---------------------------------------------------------------------------


def upsert_room(sg: SceneGraphState, found, center, walls, corridor_found,
                is_ground, max_gap: float) -> SceneGraphState:
    """Write a room / corridor candidate (``found``; its ``center``, 4
    ``walls`` with -1 for a corridor's missing pair) into the room table:
    the biggest ground plane within ``max_gap`` of its centre is its
    ground, and it updates the existing room it shares two walls with or
    lies within 1.5 m of (roomAssociation), else takes the next free slot.
    """
    R = sg.room_valid.shape[0]
    g_lat = torch.linalg.norm(sg.pl_centroid - center[None, :], dim=-1)
    g_ok = is_ground & (g_lat < max_gap)
    g_best = torch.argmax(torch.where(g_ok, sg.pl_npts, -1.0))
    ground_id = torch.where(found & torch.any(g_ok),
                            g_best.to(torch.int32), -1)
    shared = torch.sum((sg.room_walls[:, :, None] == walls[None, None, :])
                       & (sg.room_walls[:, :, None] >= 0), dim=(1, 2))
    cdist = torch.linalg.norm(sg.room_center - center[None, :], dim=-1)
    cand = sg.room_valid & ((cdist < 1.5) | (shared >= 2))
    match = torch.argmin(torch.where(cand, cdist, torch.inf))
    matched = found & _take(cand, match)
    slot = torch.where(matched, match,
                       torch.clamp(sg.n_rooms, max=R - 1).long())
    can = found & (matched | (sg.n_rooms < R))
    return sg._replace(
        room_center=_put(sg.room_center, slot, torch.where(
            can, center, _take(sg.room_center, slot))),
        room_walls=_put(sg.room_walls, slot, torch.where(
            can, walls, _take(sg.room_walls, slot))),
        room_is_corridor=_put(sg.room_is_corridor, slot, torch.where(
            can, corridor_found, _take(sg.room_is_corridor, slot))),
        room_ground=_put(sg.room_ground, slot, torch.where(
            can, ground_id, _take(sg.room_ground, slot))),
        room_valid=_put(sg.room_valid, slot,
                        can | _take(sg.room_valid, slot)),
        n_rooms=sg.n_rooms + (can & ~matched).to(torch.int32),
    )


def detect_rooms_torch(sg: SceneGraphState, min_votes: float = 3.0,
                       min_gap: float = 0.8, max_gap: float = 12.0,
                       perp_tol: float = 0.2,
                       max_candidates: int = 3) -> SceneGraphState:
    """Plain twin of K23's wall entry (reference ``manager.py:310``)."""
    if sg.pl_coeffs.is_cuda:
        detect_rooms_torch.cuda_calls += 1
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    dev = sg.pl_coeffs.device
    n = sg.pl_coeffs[:, :3]
    is_ground = sg.pl_valid & (sem == GROUND)
    ar = torch.arange(P, device=dev)
    pi = ar.repeat_interleave(P)
    pj = ar.repeat(P)
    wall_free = sg.pl_valid & (sem == WALL)
    for _ in range(max_candidates):
        is_wall = wall_free
        dot = n @ n.T
        cdiff = sg.pl_centroid[None, :, :] - sg.pl_centroid[:, None, :]
        gap = torch.abs(torch.einsum("pi,pqi->pq", n, cdiff))
        lateral = torch.linalg.norm(
            cdiff - torch.einsum("pqi,pi->pq", cdiff, n)[..., None]
            * n[:, None, :], dim=-1)
        facing = (is_wall[:, None] & is_wall[None, :] & (dot < -0.9)
                  & (gap > min_gap) & (gap < max_gap) & (lateral < max_gap)
                  & (ar[:, None] < ar[None, :]))
        pair_center = 0.5 * (sg.pl_centroid[:, None, :]
                             + sg.pl_centroid[None, :, :])
        fac_flat = facing.reshape(-1)
        pc_flat = pair_center.reshape(P * P, 3)
        support = torch.where(fac_flat, sg.pl_npts[pi] + sg.pl_npts[pj], -1.0)
        b1 = torch.argmax(support)
        i1, j1 = _take(pi, b1), _take(pj, b1)
        have1 = _take(support, b1) > 0
        n1 = _take(n, i1)
        perp = torch.abs(n[pi] @ n1) < perp_tol
        c1 = _take(pc_flat, b1)
        center_dist = torch.linalg.norm(pc_flat - c1, dim=-1)
        score2 = torch.where(fac_flat & perp, -center_dist, -torch.inf)
        b2 = torch.argmax(score2)
        i2, j2 = _take(pi, b2), _take(pj, b2)
        have2 = torch.isfinite(_take(score2, b2))

        room_found = have1 & have2
        room_center = 0.5 * (c1 + _take(pc_flat, b2))
        neg = torch.full_like(i1, -1)
        room_walls = torch.stack([i1, j1, i2, j2]).to(torch.int32)
        corridor_found = have1 & ~have2
        corr_walls = torch.stack([i1, j1, neg, neg]).to(torch.int32)
        found = room_found | corridor_found
        center = torch.where(room_found, room_center, c1)
        walls = torch.where(room_found, room_walls, corr_walls)

        sg = upsert_room(sg, found, center, walls, corridor_found,
                         is_ground, max_gap)
        # consume this candidate's walls for the next round
        # duplicate rows (a corridor's -1 walls clip to row 0): the last
        # write wins, as in the reference's scatter
        used = index_set_last(torch.zeros((P,), dtype=torch.bool, device=dev),
                              torch.clamp(walls, 0, P - 1).long(), walls >= 0)
        wall_free = wall_free & ~torch.where(found, used, False)
    return sg


detect_rooms_torch.cuda_calls = 0

# K23's operands: the plane table it reads and the room table it returns
# anew, in its pointer order, and their dtypes
_ROOM_PLANES = {"pl_coeffs": _F32, "pl_valid": _BOOL, "pl_centroid": _F32,
                "pl_npts": _F32, "pl_votes": _F32}
_ROOM_TABLES = {"room_center": _F32, "room_walls": _I32,
                "room_is_corridor": _BOOL, "room_valid": _BOOL,
                "room_ground": _I32, "n_rooms": _I32}


def launch_rooms(entry: str, sg: SceneGraphState, *args) -> SceneGraphState:
    """Launch K23's C entry ``entry`` on ``sg``'s plane and room tables;
    ``args`` are the entry's operands after the room table (tensors by
    pointer).  Returns ``sg`` with the new room table."""
    planes = [getattr(sg, k) for k in _ROOM_PLANES]
    rooms = [getattr(sg, k) for k in _ROOM_TABLES]
    cuda.require_cuda(entry, *planes, *rooms,
                      *(a for a in args if isinstance(a, torch.Tensor)))
    if any(t.dtype != dt for t, dt in zip(
            planes + rooms, [*_ROOM_PLANES.values(),
                             *_ROOM_TABLES.values()])):
        raise ValueError(f"{entry}: the scene-graph state's dtypes")
    outs = [torch.empty_like(t) for t in rooms]
    cuda.call(entry, *map(cuda.ptr, planes), sg.P, *map(cuda.ptr, rooms),
              sg.room_valid.shape[0],
              *(cuda.ptr(a) if isinstance(a, torch.Tensor) else a
                for a in args),
              *map(cuda.ptr, outs), cuda.stream())
    return sg._replace(**dict(zip(_ROOM_TABLES, outs)))


def detect_rooms(sg: SceneGraphState, min_votes: float = 3.0,
                 min_gap: float = 0.8, max_gap: float = 12.0,
                 perp_tol: float = 0.2,
                 max_candidates: int = 3) -> SceneGraphState:
    """Facing-wall-pair analysis -> corridor (2-wall) / room (4-wall)
    candidates, ``max_candidates`` greedy rounds that consume their walls,
    each with the nearest ground plane attached
    (SemanticsManager::detectMapRoomCandidate*, GeoSemHelpers.cc:421-459).
    Kernel K23 (``rooms_walls``) on CUDA tensors, the twin on CPU."""
    if sg.pl_coeffs.device.type == "cpu":
        return detect_rooms_torch(sg, min_votes, min_gap, max_gap, perp_tol,
                                  max_candidates)
    out = launch_rooms("vsg_rooms_walls", sg, float(min_votes),
                       float(min_gap), float(max_gap), float(perp_tol),
                       int(max_candidates))
    detect_rooms.launches += 1
    return out


detect_rooms.launches = 0


def refine_points_semantic(m, sg: SceneGraphState, T_cw,
                           min_votes: float = 3.0,
                           behind_thresh: float = 0.15,
                           lateral_radius: float = 2.5):
    """Cull map points lying behind a settled semantic plane, within the
    plane's observed surface voxels (Optimizer.cc:1271-1336, Plane.cc:
    81-140).  ``lateral_radius`` is unused, as in the reference, whose
    voxel membership test replaced it.  Returns the updated map."""
    sem = plane_semantics(sg, min_votes)
    planes_ok = sg.pl_valid & (sem != UNDEFINED)
    n = sg.pl_coeffs[:, :3]
    d = sg.pl_coeffs[:, 3]
    C = lie.se3_inverse(T_cw)[4:7]
    side_cam = n @ C + d  # (P,)
    sd = m.pt_pos @ n.T + d[None, :]  # (N, P)
    proj = m.pt_pos[:, None, :] - sd[:, :, None] * n[None, :, :]
    keys = voxel_key(proj)  # (N, P)
    slots = voxel_slot(keys, sg.pl_vox.shape[1])
    in_extent = torch.gather(sg.pl_vox, 1, slots.T.long()).T == keys
    behind = ((sd * side_cam[None, :] < 0) & (torch.abs(sd) > behind_thresh)
              & in_extent & planes_ok[None, :])
    bad = m.pt_valid & torch.any(behind, dim=1)
    obs = m.kf_obs_pt
    linked_bad = (obs >= 0) & bad[torch.clamp(obs, min=0).long()]
    return m._replace(
        pt_valid=m.pt_valid & ~bad,
        pt_freed_seq=torch.where(bad, m.n_kf, m.pt_freed_seq),
        kf_obs_pt=torch.where(linked_bad, -1, obs),
    )


def plane_covis_bonus(sg: SceneGraphState, kf_id: int, K: int,
                      min_votes: float = 3.0, score: float = 10.0,
                      undefined_factor: float = 0.2) -> torch.Tensor:
    """(K,) covisibility bonus from planes shared with keyframe ``kf_id``
    (KeyFrame::UpdateConnections' plane weighting, KeyFrame.cc:486-523)."""
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    ob_ok = (sg.ob_valid & (sg.ob_plane >= 0) & (sg.ob_kf >= 0)
             & (sg.ob_kf < K))
    flat = (torch.clamp(sg.ob_kf, 0, K - 1).long() * P
            + torch.clamp(sg.ob_plane, min=0).long())
    member = torch.zeros((K * P,), dtype=torch.int32,
                         device=sg.ob_kf.device)
    member.scatter_reduce_(0, flat, ob_ok.to(torch.int32), "amax")
    member = member.reshape(K, P) > 0
    mine = member[kf_id]
    w = torch.where(sem != UNDEFINED, score, score * undefined_factor)
    w = torch.where(sg.pl_valid, w, 0.0)
    bonus = torch.sum((member & mine[None, :]).to(w.dtype) * w[None, :],
                      dim=1)
    bonus[kf_id].fill_(0.0)
    return bonus


def filter_semantic_planes(sg: SceneGraphState, min_votes: float = 3.0,
                           max_tilt_wall: float = 0.25,
                           max_tilt_ground: float = 0.25,
                           max_step_elevation: float = 0.5
                           ) -> SceneGraphState:
    """Reset the votes of walls tilted out of the dominant ground plane's
    frame and of grounds a step away from it or tilted
    (SemanticsManager::filterWallPlanes / filterGroundPlanes)."""
    sem = plane_semantics(sg, min_votes)
    is_g = sg.pl_valid & (sem == GROUND)
    has_g = torch.any(is_g)
    gidx = torch.argmax(torch.where(is_g, sg.pl_npts, -1.0))
    up = _take(sg.pl_coeffs, gidx)[:3]
    tilt_w = torch.abs(sg.pl_coeffs[:, :3] @ up)
    reset_w = sg.pl_valid & (sem == WALL) & (tilt_w > max_tilt_wall)
    h = sg.pl_centroid @ up
    dh = torch.abs(h - _take(h, gidx))
    align_g = torch.abs(sg.pl_coeffs[:, :3] @ up)
    reset_g = (sg.pl_valid & (sem == GROUND)
               & (torch.arange(sg.P, device=gidx.device) != gidx)
               & ((dh > max_step_elevation)
                  | (align_g < 1.0 - max_tilt_ground)))
    reset = (reset_w | reset_g) & has_g
    return sg._replace(pl_votes=torch.where(reset[:, None], 0.0, sg.pl_votes))


def reassociate_planes(sg: SceneGraphState, min_votes: float = 3.0,
                       ominus_thresh: float = 0.2, dist_thresh: float = 0.25,
                       centroid_thresh: float = 2.0) -> SceneGraphState:
    """Merge the single closest same-class plane pair that optimisation
    moved together (Utils::reAssociateSemanticPlanes): the smaller plane's
    observations, votes and support move to the bigger one."""
    sem = plane_semantics(sg, min_votes)
    P = sg.P
    ar = torch.arange(P, device=sg.pl_coeffs.device)
    # diff[j, i] = ominus(ref=plane i, other=plane j)
    diff = plane_mod.ominus(sg.pl_coeffs[None, :, :], sg.pl_coeffs[:, None, :])
    ang = torch.linalg.norm(diff[..., :2], dim=-1)
    dd = torch.abs(diff[..., 2])
    cdist = torch.linalg.norm(sg.pl_centroid[:, None, :]
                              - sg.pl_centroid[None, :, :], dim=-1)
    same = (sg.pl_valid[:, None] & sg.pl_valid[None, :]
            & (sem[:, None] == sem[None, :]) & (sem[:, None] != UNDEFINED)
            & (ar[:, None] < ar[None, :]))
    mergeable = (same & (ang < ominus_thresh) & (dd < dist_thresh)
                 & (cdist < centroid_thresh))
    score = torch.where(mergeable, ang + dd, torch.inf).reshape(-1)
    flat = torch.argmin(score)
    i, j = flat // P, flat % P
    do = torch.isfinite(_take(score, flat))
    ni, nj = _take(sg.pl_npts, i), _take(sg.pl_npts, j)
    big = torch.where(ni >= nj, i, j)
    small = torch.where(ni >= nj, j, i)
    w_b = torch.clamp(_take(sg.pl_npts, big), min=1.0)
    w_s = torch.clamp(_take(sg.pl_npts, small), min=1.0)
    alpha = w_s / (w_b + w_s)
    c_big = _take(sg.pl_centroid, big)
    new_centroid = c_big * (1 - alpha) + _take(sg.pl_centroid, small) * alpha
    big32 = big.to(torch.int32)
    return sg._replace(
        pl_votes=_add(sg.pl_votes, big, torch.where(
            do, _take(sg.pl_votes, small), 0.0)),
        pl_npts=_add(sg.pl_npts, big, torch.where(
            do, _take(sg.pl_npts, small), 0.0)),
        pl_nobs=_add(sg.pl_nobs, big, torch.where(
            do, _take(sg.pl_nobs, small), 0)),
        pl_centroid=_put(sg.pl_centroid, big,
                         torch.where(do, new_centroid, c_big)),
        pl_valid=_put(sg.pl_valid, small,
                      torch.where(do, False, _take(sg.pl_valid, small))),
        ob_plane=torch.where(do & (sg.ob_plane == small), big32, sg.ob_plane),
        room_walls=torch.where(do & (sg.room_walls == small), big32,
                               sg.room_walls),
        room_ground=torch.where(do & (sg.room_ground == small), big32,
                                sg.room_ground),
    )


# ---------------------------------------------------------------------------
# host-side manager
# ---------------------------------------------------------------------------


class SceneGraphManager:
    """Attachable scene-graph pipeline (``system.scenegraph = manager``),
    on ``device`` (the card unless the caller asks for the CPU).

    RANSAC samples come from ``hypotheses(n_det, n_hyp, n_cloud)`` when
    given (a callable returning an int tensor, e.g. another
    implementation's draws), else from the manager's CPU
    ``torch.Generator`` seeded with ``seed``; either way they are drawn on
    the host and copied to the device without a sync."""

    def __init__(self, cfg: SceneGraphConfig = SceneGraphConfig(),
                 capacity: CapacityConfig | None = None, seed: int = 0,
                 device: torch.device | str = "cuda", hypotheses=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = empty_scenegraph(capacity or CapacityConfig(),
                                      device=self.device)
        self._gen = torch.Generator().manual_seed(seed)
        self.hypotheses = hypotheses
        self._pending_sem: dict = {}
        # host mirror of n_obs, one keyframe behind (read through the
        # keyframe slot board, never by a sync of its own)
        self.n_obs_host = 0
        self._kf_count = 0
        self.maintenance_interval = 4  # keyframes between maintenance runs
        # room_method="freespace": the observed-free voxel grid, the
        # voxblox skeleton's stand-in (transient, not checkpointed)
        self._free_grid: torch.Tensor | None = None
        self._free_origin: torch.Tensor | None = None

    def update_freespace(self, depth_img, T_cw, cam_K) -> None:
        """Carve this keyframe's observed free space into the grid (K17a;
        reference ``manager.py:661``).  The first call makes the (G, G, G)
        grid, centred on that camera (origin C - G voxel / 2, computed on
        the device); later calls update it in place."""
        from visual_sgraphs_tpu_torch.scenegraph import freespace as fs

        G, vox = self.cfg.freespace_grid, self.cfg.freespace_voxel
        T_cw = torch.as_tensor(T_cw, device=self.device)
        if self._free_grid is None:
            self._free_grid = torch.zeros((G, G, G), dtype=torch.bool,
                                          device=self.device)
            self._free_origin = lie.se3_inverse(T_cw)[4:7] - 0.5 * G * vox
        fs.accumulate_freespace(
            self._free_grid, self._free_origin, vox,
            torch.as_tensor(depth_img, device=self.device), T_cw,
            torch.as_tensor(cam_K, device=self.device))

    def infer_rooms_freespace(self) -> None:
        """Cluster the grid (K17b) and upsert the room candidates its
        clusters seed (detectMapRoomCandidateVoxblox; reference
        ``manager.py:685``)."""
        from visual_sgraphs_tpu_torch.scenegraph import freespace as fs

        if self._free_grid is None:
            return
        centers, valid = fs.freespace_cluster_centers(
            self._free_grid, self._free_origin, self.cfg.freespace_voxel)
        self.state = fs.detect_rooms_freespace(
            self.state, centers, valid, min_votes=self.cfg.plane_min_votes,
            wall_dist=self.cfg.room_wall_dist_thresh)

    def draw_hypotheses(self, n_det: int = 4, n_hyp: int = 192,
                        n_cloud: int = 2048) -> torch.Tensor:
        """(n_det, n_hyp, 3) int32 RANSAC samples on the manager's
        device (a pinned, non-blocking copy on CUDA)."""
        if self.hypotheses is not None:
            idx = torch.as_tensor(self.hypotheses(n_det, n_hyp, n_cloud))
            # checked on the host: the kernel indexes the cloud with them
            if (tuple(idx.shape) != (n_det, n_hyp, 3) or int(idx.min()) < 0
                    or int(idx.max()) >= n_cloud):
                raise ValueError("hypotheses: expected (n_det, n_hyp, 3) "
                                 f"indices in [0, {n_cloud})")
        else:
            idx = torch.randint(0, n_cloud, (n_det, n_hyp, 3),
                                generator=self._gen)
        idx = idx.to(torch.int32)
        if self.device.type == "cuda":
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx.to(self.device)

    def provide_semantics(self, timestamp: float, sem_img, conf_img=None):
        """Register a per-pixel class image (and optional confidence in
        [0, 1]) for the frame at ``timestamp`` (host float64)."""
        self._pending_sem[float(timestamp)] = (sem_img, conf_img)

    def pop_semantics(self, ts: float | None, max_dt: float = 0.05):
        """Pop the semantics registered nearest to ``ts`` (within
        ``max_dt`` s); entries older than ts - 1 s are dropped."""
        if ts is None or not self._pending_sem:
            return None
        ts = float(ts)
        best = min(self._pending_sem.keys(), key=lambda k: abs(k - ts))
        out = None
        if abs(best - ts) <= max_dt:
            out = self._pending_sem.pop(best)
        for k in [k for k in self._pending_sem if k < ts - 1.0]:
            del self._pending_sem[k]
        return out

    # ---- queries (host numpy; each reads the device)

    def planes(self) -> dict:
        sem = plane_semantics(self.state, self.cfg.plane_min_votes)
        ok = self.state.pl_valid.cpu().numpy()
        return {
            "coeffs": self.state.pl_coeffs.cpu().numpy()[ok],
            "centroid": self.state.pl_centroid.cpu().numpy()[ok],
            "semantic": sem.cpu().numpy()[ok],
            "n_points": self.state.pl_npts.cpu().numpy()[ok],
        }

    def rooms(self) -> dict:
        ok = self.state.room_valid.cpu().numpy()
        return {
            "center": self.state.room_center.cpu().numpy()[ok],
            "walls": self.state.room_walls.cpu().numpy()[ok],
            "is_corridor": self.state.room_is_corridor.cpu().numpy()[ok],
            "meta_marker": self.state.room_marker.cpu().numpy()[ok],
        }


def sign_duplicates(coeffs: np.ndarray, tol: float = 0.02) -> list:
    """Pairs (i, j) of planes in ``coeffs`` (n, 4) that are one plane with
    opposite normals (|p_i + p_j| < tol componentwise)."""
    c = np.asarray(coeffs, np.float64)
    return [(i, j) for i in range(len(c)) for j in range(i + 1, len(c))
            if np.abs(c[i] + c[j]).max() < tol]
