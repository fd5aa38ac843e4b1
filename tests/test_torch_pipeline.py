"""The B-frame pipeline (``pipeline_depth`` > 1) against the reference's:
the tracking scan and the cycle program on a mid-stream reference map.
Whole pipelined runs: ``test_torch_pipeline_run.py`` (both packages) and
``test_torch_pipeline_flush.py`` (the reference's partial-flush gate on
the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu.slam.cycle_program import (
    make_cycle_program as ref_cycle_program,
)
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.slam import tracking as ptrack
from visual_sgraphs_tpu_torch.slam.cycle_program import (
    make_cycle_program as port_cycle_program,
)

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

B = 8
MIN_INLIERS = 15
# the scan's poses: the single-frame tracking test's 1e-4, over a chain of
# eight frames each starting from the one before
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def snap():
    return tp.scan_snapshot(10, 2 * B)


def _batch(frames):
    return (np.stack([g for g, _, _, _ in frames]),
            np.stack([d for _, d, _, _ in frames]),
            [ts for _, _, _, ts in frames])


def _ref_scan(snap, frames, T_last, vel):
    cfg = snap["cfg"]
    scan = rtrack.make_frame_scan(cfg.camera, cfg.orb, 10, 4096, 15.0, 7.0,
                                  True, B)
    g, d, ts = _batch(frames)
    return scan(snap["map"], jnp.asarray(g), jnp.asarray(d),
                jnp.asarray(ts, jnp.float32), jnp.asarray(T_last),
                jnp.asarray(vel), jnp.asarray(snap["ref_kf"], jnp.int32),
                jnp.asarray(cfg.camera.K), jnp.asarray(MIN_INLIERS, jnp.int32),
                jnp.asarray(np.float32(cfg.camera.bf)))


def _start(snap, retry: bool):
    # ``retry``: the velocity is 0.5 m off, so the first frame's prediction
    # fails and the wide-window re-track from the last pose takes over
    vel = snap["velocity"].copy()
    if retry:
        vel[4] += 0.5
    return snap["last_pose"], vel


@pytest.mark.parametrize("retry", [False, True])
def test_frame_scan_matches_reference(snap, retry):
    # packed counters and match tables exact (integer outputs of the same
    # matches), poses within POSE_TOL; the retry is chosen on the device
    cfg = snap["cfg"]
    T_last, vel = _start(snap, retry)
    frames = snap["later"][:B]
    r = _ref_scan(snap, frames, T_last, vel)
    pcfg = tp.port_config(cfg)
    scan = ptrack.make_frame_scan(pcfg.camera, pcfg.orb, 10, 4096, 15.0, 7.0,
                                  True, B)
    g, d, ts = _batch(frames)
    p = scan(tp.port_map(snap["map"]), tp.t(g), tp.t(d), ts, tp.t(T_last),
             tp.t(vel), snap["ref_kf"], tp.t(cfg.camera.K), MIN_INLIERS,
             torch.tensor(np.float32(cfg.camera.bf)))
    r_packed = np.asarray(r[3])
    assert (r_packed[:, 3] > 0).any() == retry
    assert (r_packed[:, 1] >= MIN_INLIERS).all()
    np.testing.assert_array_equal(p[3].numpy(), r_packed)
    np.testing.assert_array_equal(p[1].slot_pt.numpy(),
                                  np.asarray(r[1].slot_pt))
    np.testing.assert_array_equal(p[1].vis_pt.numpy(), np.asarray(r[1].vis_pt))
    # the batch's ORB: keypoints exact; a BRIEF test at a near-tie may
    # flip with the pyramid's float32 rounding (1e-4 on [0, 255])
    np.testing.assert_array_equal(p[0].uv.numpy(), np.asarray(r[0].uv))
    assert (p[0].desc.numpy() != np.asarray(r[0].desc)).mean() < 1e-4
    for a, b in ((p[2], r[2]), (p[4], r[4]), (p[5], r[5])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=POSE_TOL)


def test_cycle_program_matches_reference(snap):
    # the cycle after one scanned batch: its frame 5 inserted as keyframe
    # (with the windowed BA and the culls), then the next batch scanned.
    # The previous batch's outputs are the reference's, handed to both.
    # Boards and counters exact; keyframe poses within 1e-4 and points
    # within 1e-3 (test_torch_mapping.py's rule for the BA); scan poses
    # within POSE_TOL of the reference's
    cfg = snap["cfg"]
    T_last, vel = _start(snap, False)
    first, second = snap["later"][:B], snap["later"][B:]
    r_prev = _ref_scan(snap, first, T_last, vel)
    i_kf, kf_slot = 5, int(np.flatnonzero(~np.asarray(
        snap["map"].kf_valid))[0])
    mc = cfg.mapping
    args = dict(n_window=10, fx_radius=15.0, fine_radius=7.0, batch=B,
                sg_cfg=None, loop_on=False, lba_iters=mc.lba_iters,
                cull_min_obs=mc.point_cull_min_obs,
                cull_min_found_ratio=mc.point_cull_min_found_ratio,
                cull_kf_redundancy=mc.kf_cull_redundancy, min_gap=10,
                top_n=3, quarantine=B)
    g, d, ts = _batch(second)
    _, d_prev, _ = _batch(first)
    K, bf = cfg.camera.K, np.float32(cfg.camera.bf)
    r_prog = ref_cycle_program(cfg.camera, cfg.orb, **args)
    r = r_prog(snap["map"], None, None, None, r_prev[0], r_prev[1],
               r_prev[3], r_prev[2], jnp.asarray(True),
               jnp.asarray(i_kf, jnp.int32), jnp.asarray(kf_slot, jnp.int32),
               jnp.asarray(snap["ref_kf"], jnp.int32), jnp.asarray(d_prev),
               jnp.full((1, 1), -1, jnp.int32), jnp.ones((1, 1), jnp.float32),
               jax.random.PRNGKey(0), jnp.asarray(g), jnp.asarray(d),
               jnp.asarray(ts, jnp.float32), r_prev[5], jnp.asarray(K),
               jnp.asarray(bf), jnp.asarray(MIN_INLIERS, jnp.int32),
               jnp.asarray(True), jnp.asarray(True), jnp.asarray(False))
    pcfg = tp.port_config(cfg)
    p_prog = port_cycle_program(pcfg.camera, pcfg.orb, **args)
    frames_prev = interop.frame_from_numpy(tp.to_np(r_prev[0]))
    results_prev = interop.track_from_numpy(tp.to_np(r_prev[1]))
    p = p_prog(tp.port_map(snap["map"]), None, None, None, frames_prev,
               results_prev, tp.t(r_prev[3]), tp.t(r_prev[2]), True, i_kf,
               kf_slot, snap["ref_kf"], tp.t(d_prev), None, None, None,
               tp.t(g), tp.t(d), ts, tp.t(r_prev[5]), tp.t(K),
               torch.tensor(bf), MIN_INLIERS, True, True, False)
    r_map, r_kf, r_board = r[0], int(r[3]), np.asarray(r[5])
    p_map, p_kf, p_board = p[0], p[3], p[4].numpy()
    assert p_kf == r_kf == kf_slot
    np.testing.assert_array_equal(p_board[:5], r_board)
    for f in ("kf_valid", "kf_obs_pt", "pt_valid", "pt_found",
              "pt_visible", "n_kf", "n_pt"):
        np.testing.assert_array_equal(getattr(p_map, f).numpy(),
                                      np.asarray(getattr(r_map, f)),
                                      err_msg=f)
    np.testing.assert_allclose(p_map.kf_pose.numpy(),
                               np.asarray(r_map.kf_pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_map.pt_pos.numpy(),
                               np.asarray(r_map.pt_pos), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(p[8].numpy(), np.asarray(r[9]))
    for a, b in ((p[7], r[8]), (p[9], r[10]), (p[10], r[11])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=POSE_TOL)
