"""Whole-run harness of the B-frame pipeline parity tests (not a test
module): ``tests/test_pipeline.py``'s configuration and frames, the port's
run over them, and the reference's pipelined run in its own float32
numerics (cached in ``build/test_cache``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.scenegraph.manager import SceneGraphManager as RefMgr
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager as PortMgr,
)
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import KeyframeDepthReference

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
