"""The keyframe program: the whole per-keyframe pipeline in one call.

Port of ``visual_sgraphs_tpu/slam/kf_program.py``: lazy found/visible
stats with the insertion and point seeding (K27), observation fusion
(K28 around a tracking pass), point + keyframe culling (K29), and
either the plain windowed local BA or, with the scene graph on, plane
detection (K12-K14) and association, the periodic plane
maintenance, wall-based room detection (skipped with
``room_method="freespace"``, whose rooms the system infers before the
program), semantic map-point refinement and the scene-graph local BA
(its factors assembled by K21); then, with loop closing on, the place
query (K10, K11, ``place/loop_closer.py::_detect_program``), whose
scalars join the keyframe board.  The reference traces the
cadence flags as ``lax.cond``s so one compiled program serves every
combination; the port runs eagerly, so they are plain Python ``if``s on
host booleans.
"""

from __future__ import annotations

import functools

import torch

from visual_sgraphs_tpu_torch.optim.fast_ba import (
    fast_local_ba,
    fast_scenegraph_ba,
)
from visual_sgraphs_tpu_torch.place.loop_closer import _detect_program
from visual_sgraphs_tpu_torch.scenegraph import manager as sgm
from visual_sgraphs_tpu_torch.slam import mapping


@functools.lru_cache(maxsize=None)
def make_kf_program(sg_cfg, loop_on: bool, n_window: int, lba_iters: int,
                    cull_min_obs: int, cull_min_found_ratio: float,
                    cull_kf_redundancy: float, min_gap: int, top_n: int,
                    quarantine: int = 3):
    """Build the keyframe program.

    ``program(m, sg, db, vocab, frame, pose, slot_pt, kf_slot,
    stats_slots, stats_vis, depth_img, sem_img, conf_img, hyp_idx, cam_K,
    cam_bf, do_lba, do_cull, do_maint)`` returns (map, scenegraph,
    database, kf_slot, board); ``stats_slots`` / ``stats_vis`` (None: no
    fold) are the found / visible tables folded before the insertion, in
    its launch.  ``board`` is the device float32 vector
    [slot, n_kf, n_pt, culled slot or -1, evicted, n_obs] that the host
    checks against its slot mirror one keyframe later, followed with
    ``loop_on`` by the place query's packed scalars (2 top_n + 3: best
    covisible score, candidate ids and scores, valid rows, n_obs).  With
    ``sg_cfg=None`` the scene-graph operands are ignored (pass None) and
    n_obs reads 0; without ``loop_on`` ``db`` / ``vocab`` are ignored."""
    def program(m, sg, db, vocab, frame, pose, slot_pt, kf_slot: int,
                stats_slots, stats_vis, depth_img, sem_img, conf_img,
                hyp_idx, cam_K, cam_bf, do_lba: bool, do_cull: bool,
                do_maint: bool):
        dev = pose.device
        m, kf, evicted = mapping.insert_keyframe(
            m, frame, pose, slot_pt, cam_K, slot=kf_slot,
            quarantine=quarantine,
            stats=None if stats_slots is None else (stats_slots, stats_vis))
        m = mapping.fuse_observations(m, kf, cam_K)
        if do_cull:
            m, culled = mapping.cull_map(m, kf, cull_min_obs,
                                         cull_min_found_ratio,
                                         cull_kf_redundancy)
        else:
            culled = torch.full((), -1, dtype=torch.int32, device=dev)
        if sg_cfg is None:
            if do_lba:
                m, _ = fast_local_ba(m, kf, cam_K, cam_bf,
                                     n_window=n_window, iters=lba_iters)
            n_obs = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            m, sg = _scenegraph_stages(
                sg_cfg, m, sg, kf, evicted, culled, depth_img, sem_img,
                conf_img, hyp_idx, cam_K, cam_bf, do_lba, do_maint,
                n_window, lba_iters)
            n_obs = sg.n_obs
        board = torch.stack([
            torch.full((), float(kf), device=dev),
            m.n_kf.to(torch.float32),
            m.n_pt.to(torch.float32),
            culled.to(torch.float32),
            evicted.to(torch.float32),
            n_obs.to(torch.float32),
        ])
        if loop_on:
            db, packed = _detect_program(m, db, vocab, kf, min_gap, top_n,
                                         extra=n_obs.reshape(1))
            board = torch.cat([board, packed])
        return m, sg, db, kf, board

    return program


def _scenegraph_stages(cfg, m, sg, kf: int, evicted, culled, depth_img,
                       sem_img, conf_img, hyp_idx, cam_K, cam_bf,
                       do_lba: bool, do_maint: bool, n_window: int,
                       lba_iters: int):
    """The reference's ``sg_on`` block (kf_program.py:77-149)."""
    # observations anchored on a retired keyframe slot must not survive
    # slot reuse (their Gij / locals belong to the old keyframe)
    retired = torch.where(evicted, kf, -1)
    dead = (sg.ob_kf == retired) | (sg.ob_kf == culled)
    sg = sg._replace(ob_valid=sg.ob_valid & ~dead)
    m, sg = scenegraph_keyframe(cfg, m, sg, kf, depth_img, sem_img,
                                conf_img, hyp_idx, cam_K, do_maint)
    if do_lba:
        m, sg, _ = fast_scenegraph_ba(m, sg, kf, cam_K, cam_bf,
                                      n_window=n_window, iters=lba_iters,
                                      config=cfg)
    return m, sg


def scenegraph_keyframe(cfg, m, sg, kf: int, depth_img, sem_img, conf_img,
                        hyp_idx, cam_K, do_maint: bool):
    """A keyframe's scene-graph update (SceneGraphManager.on_keyframe,
    reference ``scenegraph/manager.py:730-779``): plane detection from its
    depth (K12-K14) and association, the periodic maintenance, wall-based
    rooms (unless ``room_method="freespace"``) and the semantic map-point
    refinement.  Returns (map, scenegraph)."""
    T_cw = m.kf_pose[kf]
    (coeffs_w, det_valid, centroid, npts, votes, local, quad,
     det_vox) = sgm.detect_planes_from_depth(
        depth_img, sem_img, T_cw, cam_K, hyp_idx, conf_img=conf_img,
        dist_thresh=cfg.ransac_dist_thresh)
    sg = sgm.associate_and_update(
        sg, coeffs_w, det_valid, centroid, npts, votes, local, kf,
        det_quadric=quad, det_vox=det_vox,
        ominus_thresh=cfg.plane_assoc_ominus_thresh,
        dist_thresh=cfg.plane_assoc_dist_thresh)
    if do_maint:
        sg = sgm.reassociate_planes(
            sgm.filter_semantic_planes(sg, min_votes=cfg.plane_min_votes),
            min_votes=cfg.plane_min_votes)
    if cfg.room_method != "freespace":
        # free-space rooms come from the manager's clustering pass, run
        # before the program at maintenance cadence
        sg = sgm.detect_rooms(sg, min_votes=cfg.plane_min_votes)
    if cfg.refine_map_points:
        m = sgm.refine_points_semantic(
            m, sg, m.kf_pose[kf], min_votes=cfg.plane_min_votes,
            behind_thresh=cfg.refine_behind_thresh,
            lateral_radius=cfg.refine_lateral_radius)
    return m, sg
