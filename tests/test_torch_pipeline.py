"""The B-frame pipeline (``pipeline_depth`` > 1) against the reference's:
the tracking scan and the cycle program on a mid-stream reference map, a
pipelined run of both packages with the scene graph on (the reference in
its own float32 numerics, both on the reference's pyramid), and the
reference's own partial-flush gate (``tests/test_pipeline.py``) on the
port, with the loop weld's local BA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.scenegraph.manager import SceneGraphManager as RefMgr
from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu.slam.cycle_program import (
    make_cycle_program as ref_cycle_program,
)
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.features import pyramid as ppyr
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager as PortMgr,
)
from visual_sgraphs_tpu_torch.slam import tracking as ptrack
from visual_sgraphs_tpu_torch.slam.cycle_program import (
    make_cycle_program as port_cycle_program,
)
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import (  # noqa: F401
    KeyframeDepthReference,
    ReferenceHypotheses,
    one_torch_thread,
)

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


# ---------------------------------------------------------------- whole runs

H, W, N_FEATURES = 240, 320, 600


def bench_harness_config(depth: int, loops: bool):
    """``tests/test_pipeline.py``'s harness: the bench.py configuration at
    240x320 with 600 features (its camera scaled from 640x480)."""
    cam = rcfg.CameraConfig(fx=517.3 * W / 640, fy=516.5 * H / 480,
                            cx=318.6 * W / 640, cy=255.3 * H / 480,
                            width=W, height=H)
    cfg = rcfg.SystemConfig(
        sensor=rcfg.Sensor.RGBD, camera=cam,
        orb=rcfg.OrbConfig(n_features=N_FEATURES),
        capacity=rcfg.CapacityConfig(max_keyframes=128, max_points=32768),
        tracking=rcfg.TrackingConfig(pipeline_depth=depth),
        mapping=rcfg.MappingConfig(lba_iters=6, lba_interval=2,
                                   cull_interval=2),
        loop_closing=loops,
        place=rcfg.PlaceConfig(vocab_min_keyframes=4, consistency=1,
                               min_gap=8, gba_after_loop=False),
        strict_slot_check=True)
    return dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True))


def harness_frames(n_render: int):
    cfg = bench_harness_config(8, False)
    scene = SyntheticScene(cam=cfg.camera, h=H, w=W)

    def build():
        return [(np.asarray(g, np.float32), np.asarray(d, np.float32),
                 np.asarray(s, np.int32), np.asarray(T, np.float32), ts)
                for g, d, s, T, ts in scene.frames_with_semantics(
                    n_render, kind="orbit2")]
    return tp.cached(f"harness_frames_{n_render}", build)


def port_run(cfg, frames, hypotheses=None):
    """The port over ``frames``; ``port.n_serial`` is the number of frames
    tracked before its first batch (the serial ramp-in)."""
    pcfg = tp.port_config(cfg)
    port = PortSystem(pcfg, device="cpu")
    port.n_serial = None
    dispatch = port._dispatch_scan

    def first_scan(buf):
        if port.n_serial is None:
            port.n_serial = len(port.trajectory)
        return dispatch(buf)

    port._dispatch_scan = first_scan
    port.scenegraph = PortMgr(pcfg.scenegraph, pcfg.capacity, device="cpu",
                              hypotheses=hypotheses)
    for g, d, s, _, ts in frames:
        port.scenegraph.provide_semantics(ts, s)
        port.track_rgbd(g, d, ts)
    port.flush()
    return port


N_RUN = 56  # of the 192-frame render: the serial ramp-in (21 frames),
# then a scan and three cycles, and a 3-frame tail through flush()
POS_TOL = 0.01  # m, every frame
ATE_GATE = 0.16  # tests/test_pipeline.py's pipelined gate


def events(system) -> dict:
    return {k: system.events.count(k) for k in ("serial_relief",
                                                 "batch_retrack")}


def keyframes(system) -> list:
    return [(e["kf"], e["n_inliers"])
            for e in system.events.of_kind("keyframe")]


def reference_resize(img: torch.Tensor, shape) -> torch.Tensor:
    """The reference's resize of each (H, W) image of ``img``."""
    x = img.numpy().reshape(-1, *img.shape[-2:])
    out = np.stack([np.asarray(rpyr.resize_bilinear(jnp.asarray(f), shape))
                    for f in x])
    return torch.from_numpy(out.reshape(*img.shape[:-2], *shape))


def reference_run() -> dict:
    cfg = bench_harness_config(8, False)
    ref = KeyframeDepthReference(cfg)
    ref.scenegraph = RefMgr(cfg.scenegraph, cfg.capacity)
    for g, d, s, _, ts in harness_frames(192)[:N_RUN]:
        ref.scenegraph.provide_semantics(ts, s)
        ref.track_rgbd(g, d, ts)
    ref.flush()
    return dict(pos=np.asarray(ref.positions()),
                tracked=np.asarray(ref.tracked_mask()),
                n_traj=len(ref.trajectory), n_kf=int(ref.map.n_kf),
                keyframes=keyframes(ref), events=events(ref))


@pytest.fixture(scope="module")
def pipelined_runs():
    # Both runs in the reference's own float32 numerics (this suite's
    # conftest turns on float64, which the library never runs in), and the
    # port on the reference's resize in place of its twin: XLA's CPU matrix
    # product inside jax.image.resize adds a pair of taps' products before
    # the third, where the twin (the kernel's rounding) fuses one
    # multiply-add a tap. The levels then differ by 2-3 ulp on [0, 255]
    # (the twin is held within 1e-4 by test_torch_features.py), a FAST score
    # at a near-tie flips on most of these frames, and the two runs part by
    # ~0.15 m by frame 50; on the same pyramid they stay within 0.004 m.
    frames = harness_frames(192)[:N_RUN]
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppyr, "resize_bilinear_torch", reference_resize)
        ref = tp.cached(f"pipelined_reference_f32_{N_RUN}", reference_run)
        port = port_run(bench_harness_config(8, False), frames,
                        ReferenceHypotheses())
    return ref, port


def test_pipelined_run_matches_reference(pipelined_runs):
    ref, port = pipelined_runs
    assert port.cfg.tracking.pipeline_depth == B
    assert len(port.trajectory) == ref["n_traj"] == N_RUN
    np.testing.assert_array_equal(port.tracked_mask(), ref["tracked"])
    n = port.n_serial
    assert n >= 8 and (N_RUN - n) // B >= 4  # a scan and three cycles ran
    pos = port.positions()
    np.testing.assert_allclose(pos, ref["pos"], rtol=0, atol=POS_TOL)
    gt = np.stack([T[4:7] for _, _, _, T, _ in harness_frames(192)[:N_RUN]])
    ates = [float(pgeo.ate_rmse(torch.from_numpy(p), torch.from_numpy(gt))[0])
            for p in (pos, ref["pos"])]
    assert max(ates) <= ATE_GATE, ates
    # the same keyframes, in the same slots, chosen at the same counts
    assert int(port.map.n_kf) == ref["n_kf"]
    assert keyframes(port) == ref["keyframes"]
    assert events(port) == ref["events"]
    # the batched path ran: one readback a batch, far under one a frame
    # after the ramp-in
    assert port.host_readbacks < N_RUN


def test_pipelined_partial_batch_flush():
    # tests/test_pipeline.py::test_pipelined_partial_batch_flush on the
    # port: loops on with the loop weld (gba_after_loop=False), strict
    # slot checks, 92 of 192 frames (not a multiple of 8): the tail runs
    # through flush() and the trajectory stays frame-aligned
    frames = harness_frames(192)[:92]
    port = port_run(bench_harness_config(8, True), frames)
    assert len(port.trajectory) == 92
    gt = np.stack([T[4:7] for _, _, _, T, _ in frames])
    ate = float(pgeo.ate_rmse(torch.from_numpy(port.positions()),
                              torch.from_numpy(gt))[0])
    assert ate <= 0.2, ate
    assert port.events.count("keyframe") >= 8
