"""The keyframe program: the whole per-keyframe pipeline in one call.

Port of the scene-graph-off, loop-off variant of
``visual_sgraphs_tpu/slam/kf_program.py``: lazy found/visible stats,
insertion + point seeding, observation fusion, point + keyframe culling
and the windowed local BA.  The reference traces the cadence flags as
``lax.cond``s so one compiled program serves every combination; the port
runs eagerly, so they are plain Python ``if``s on host booleans.
"""

from __future__ import annotations

import functools

import torch

from visual_sgraphs_tpu_torch.optim.fast_ba import fast_local_ba
from visual_sgraphs_tpu_torch.slam import mapping


@functools.lru_cache(maxsize=None)
def make_kf_program(sg_cfg, loop_on: bool, n_window: int, lba_iters: int,
                    cull_min_obs: int, cull_min_found_ratio: float,
                    cull_kf_redundancy: float, min_gap: int, top_n: int,
                    quarantine: int = 3):
    """Build the keyframe program.

    ``program(m, frame, pose, slot_pt, kf_slot, stats_slots, stats_vis,
    cam_K, cam_bf, do_lba, do_cull)`` returns (map, kf_slot, board) where
    ``board`` is the device (5,) float32 [slot, n_kf, n_pt, culled slot or
    -1, evicted] that the host checks against its slot mirror."""
    if sg_cfg is not None:
        raise NotImplementedError(
            "kf_program: the scene-graph stages are not ported yet")
    if loop_on:
        raise NotImplementedError(
            "kf_program: the place-recognition query is not ported yet")

    def program(m, frame, pose, slot_pt, kf_slot: int, stats_slots,
                stats_vis, cam_K, cam_bf, do_lba: bool, do_cull: bool):
        m = mapping.apply_found_stats(m, stats_slots, stats_vis)
        m, kf, evicted = mapping.insert_keyframe(
            m, frame, pose, slot_pt, cam_K, slot=kf_slot,
            quarantine=quarantine)
        m = mapping.fuse_observations(m, kf, cam_K)
        culled = torch.full((), -1, dtype=torch.int32, device=pose.device)
        if do_cull:
            m = mapping.cull_points(m, min_obs=cull_min_obs,
                                    min_found_ratio=cull_min_found_ratio)
            m, culled = mapping.cull_keyframes(m, kf, cull_kf_redundancy)
        if do_lba:
            m, _ = fast_local_ba(m, kf, cam_K, cam_bf, n_window=n_window,
                                 iters=lba_iters)
        board = torch.stack([
            torch.full((), float(kf), device=pose.device),
            m.n_kf.to(torch.float32),
            m.n_pt.to(torch.float32),
            culled.to(torch.float32),
            evicted.to(torch.float32),
        ])
        return m, kf, board

    return program
