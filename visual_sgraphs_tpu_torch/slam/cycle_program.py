"""The per-cycle program of the B-frame pipeline: the keyframe chosen out
of batch k-1, then the tracking scan of batch k.

Port of ``visual_sgraphs_tpu/slam/cycle_program.py``.  In order, one
cycle:

1. folds batch k-1's found/visible statistics of its accepted frames
   into the map (``mapping.apply_found_stats``);
2. recomposes the chosen keyframe's pose from its relative pose
   (T_rel = T_cw . T_ref^-1, captured at its own batch's scan) onto the
   *current* reference-keyframe row, so local-BA shifts and loop
   corrections that landed since carry into the inserted keyframe;
3. runs the keyframe program (``slam/kf_program.py``), or builds the
   "skip" board when no keyframe was chosen;
4. re-anchors the tracking chain (T_last) on the post-BA reference row;
5. runs the scan of batch k (``tracking.make_frame_scan``) against the
   fresh map.

The reference composes all of it under one ``jax.jit`` and lowers the
per-cycle flags (``insert_kf``, ``do_lba``, ``do_cull``, ``do_maint``) to
``lax.cond``.  The port runs eagerly and the host decides those flags, so
they are plain Python booleans and ``if`` on them syncs nothing; what the
reference computes on the device (the statistics mask, the poses, the
boards, the retry choice inside the scan) stays on the device.
"""

from __future__ import annotations

import functools

import torch

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.slam import mapping, tracking
from visual_sgraphs_tpu_torch.slam.frame import frame_at
from visual_sgraphs_tpu_torch.slam.kf_program import make_kf_program


@functools.lru_cache(maxsize=None)
def make_cycle_program(cam, orb, n_window: int, fx_radius: float,
                       fine_radius: float, batch: int, sg_cfg, loop_on: bool,
                       lba_iters: int, cull_min_obs: int,
                       cull_min_found_ratio: float,
                       cull_kf_redundancy: float, min_gap: int, top_n: int,
                       quarantine: int = 3):
    """Build the cycle program.

    ``cycle(m, sg, db, vocab, frames_prev, results_prev, packeds_prev,
    T_rels_prev, insert_kf, i_kf, kf_slot, ref_old, depths_prev, sem_img,
    conf_img, hyp_idx, grays, depths, tss, velocity, cam_K, cam_bf,
    min_inliers, do_lba, do_cull, do_maint, timers=None)`` returns (map,
    scenegraph, database, kf slot, board, frames, results, T_rels,
    packeds, T_out, vel_out).  ``board`` is the keyframe program's (see
    ``make_kf_program``) or, without a keyframe, the skip board [ref_old,
    n_kf, n_pt, -1, 0, n_obs]."""
    scan = tracking.make_frame_scan(cam, orb, n_window, 4096, fx_radius,
                                    fine_radius, True, batch)
    kf_prog = make_kf_program(sg_cfg, loop_on, n_window, lba_iters,
                              cull_min_obs, cull_min_found_ratio,
                              cull_kf_redundancy, min_gap, top_n, quarantine)

    def cycle(m, sg, db, vocab, frames_prev, results_prev, packeds_prev,
              T_rels_prev, insert_kf: bool, i_kf: int, kf_slot: int,
              ref_old: int, depths_prev, sem_img, conf_img, hyp_idx, grays,
              depths, tss, velocity, cam_K, cam_bf, min_inliers: int,
              do_lba: bool, do_cull: bool, do_maint: bool, timers=None):
        # fold the previous batch's per-frame found/visible statistics
        # (MapPoint mnFound / mnVisible, Tracking::TrackLocalMap) of its
        # accepted frames: one launch of K27's stats entry on the card
        if T_rels_prev.is_cuda:
            make_cycle_program.cuda_cycles += 1
        m = mapping.apply_found_stats(m, results_prev.slot_pt,
                                      results_prev.vis_pt, packeds_prev,
                                      min_inliers)
        dev = T_rels_prev.device
        if insert_kf:
            pose_kf = lie.se3_normalize(lie.se3_multiply(
                T_rels_prev[i_kf], m.kf_pose[ref_old]))
            m, sg, db, kf, board = kf_prog(
                m, sg, db, vocab, frame_at(frames_prev, i_kf), pose_kf,
                results_prev.slot_pt[i_kf], kf_slot, None, None,
                depths_prev[i_kf], sem_img, conf_img, hyp_idx, cam_K,
                cam_bf, do_lba, do_cull, do_maint)
        else:
            kf = ref_old
            n_obs = (sg.n_obs.to(torch.float32) if sg is not None
                     else torch.zeros((), device=dev))
            board = torch.stack([
                torch.full((), float(ref_old), device=dev),
                m.n_kf.to(torch.float32), m.n_pt.to(torch.float32),
                torch.full((), -1.0, device=dev),
                torch.zeros((), device=dev), n_obs])
        # re-anchor the tracking chain on the (post-BA / post-correction)
        # reference row, then track the new batch against the fresh map
        T_last = lie.se3_normalize(lie.se3_multiply(T_rels_prev[-1],
                                                    m.kf_pose[ref_old]))
        frames, results, T_rels, packeds, T_out, vel_out = scan(
            m, grays, depths, tss, T_last, velocity, kf, cam_K, min_inliers,
            cam_bf, timers)
        return (m, sg, db, kf, board, frames, results, T_rels, packeds,
                T_out, vel_out)

    return cycle


# cycles run on the card (K27's stats entry launches once each)
make_cycle_program.cuda_cycles = 0
