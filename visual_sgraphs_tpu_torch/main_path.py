"""The port's main path as its scripts run it: configuration, frames, feed.

``chip_smoke.py`` and ``profile_slice`` both drive this path, so both take
the configuration behind their numbers from here.  ``bench_config`` is the
headline configuration of the reference's ``bench.py:64-91`` exactly:
640x480 RGB-D, 1000 ORB features, 128 keyframes / 32768 points, the
B-frame pipeline (``pipeline_depth=8``), ``MappingConfig(lba_iters=6,
lba_interval=2, cull_interval=2)``, loop closing with a global BA after
each loop, and the scene graph with plane covisibility and semantic point
refinement, over the 192-frame two-lap ``orbit2`` sequence rendered with
semantics (``BENCH_FRAMES``, the first ``BENCH_WARMUP`` of them warm-up).
``configs`` and ``loop_config`` are the earlier slices' cuts of it to
``pipeline_depth=1`` (scene graph off / on, then loops), over 96 frames;
``freespace_config`` is the scene-graph cut with free-space rooms.
``inertial_config`` is the reference's second benchmarked row
(``bench.py:184-193``): RGB-D with an IMU (``Sensor.IMU_RGBD``), 1000
features, 64 keyframes / 16384 points, over the 128-frame ``orbit``
sequence with its 200 Hz IMU samples (``INERTIAL_FRAMES``, the first
``INERTIAL_WARMUP`` of them warm-up).
"""

from __future__ import annotations

import dataclasses

from visual_sgraphs_tpu_torch.config import (
    CapacityConfig,
    ImuConfig,
    MappingConfig,
    OrbConfig,
    PlaceConfig,
    Sensor,
    SystemConfig,
    TrackingConfig,
)

N_FRAMES = 96
BENCH_FRAMES = 192
BENCH_WARMUP = 64
HEADLINE_CAPACITY = CapacityConfig(max_keyframes=128, max_points=32768)
INERTIAL_FRAMES = 128
INERTIAL_WARMUP = 48


def frames(device, n: int = N_FRAMES, h: int = 480, w: int = 640,
           kind: str = "orbit2"):
    """(scene, [(gray, depth, sem, T_wc, ts)]) rendered on ``device``."""
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    scene = SyntheticScene(h=h, w=w, device=device)
    return scene, list(scene.frames_with_semantics(n, kind=kind))


def configs(scene, n_features: int = 1000,
            capacity: CapacityConfig = HEADLINE_CAPACITY):
    """(scene graph off, scene graph on) system configurations."""
    cfg = SystemConfig(
        camera=scene.cam, orb=OrbConfig(n_features=n_features),
        capacity=capacity,
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        profile=True)
    # the headline configuration's scene-graph behaviours (bench.py:87-88)
    return cfg, dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True))


def freespace_config(scene):
    """``freespace_slice``'s configuration: the serial scene-graph
    configuration of ``configs`` with the reference's primary room method,
    free-space rooms (``room_method="freespace"``)."""
    _, sg_cfg = configs(scene)
    return dataclasses.replace(sg_cfg, scenegraph=dataclasses.replace(
        sg_cfg.scenegraph, room_method="freespace"))


def loop_config(cfg):
    """``cfg`` with the headline's loop closing (``bench.py:82-86``): the
    vocabulary trained at 4 keyframes, single-keyframe consistency, an
    8-keyframe gap, a global BA after each accepted loop."""
    return dataclasses.replace(cfg, loop_closing=True, place=PlaceConfig(
        vocab_min_keyframes=4, consistency=1, min_gap=8,
        gba_after_loop=True))


def bench_config(scene):
    """The headline configuration of ``bench.py:64-91``: the scene-graph
    configuration of ``configs`` with its loop closing (``loop_config``)
    on the B-frame pipeline, ``pipeline_depth=8``."""
    _, sg_cfg = configs(scene)
    return dataclasses.replace(loop_config(sg_cfg),
                               tracking=TrackingConfig(pipeline_depth=8))


def inertial_config(scene, n_features: int = 1000,
                    capacity: CapacityConfig = CapacityConfig(
                        max_keyframes=64, max_points=16384)):
    """The inertial row of ``bench.py:184-193`` exactly (with the stage
    timers on); ``n_features`` / ``capacity`` cut it to a test size."""
    return SystemConfig(
        sensor=Sensor.IMU_RGBD, camera=scene.cam,
        orb=OrbConfig(n_features=n_features), capacity=capacity,
        imu=ImuConfig(),
        mapping=MappingConfig(lba_iters=6, lba_interval=2, cull_interval=2),
        profile=True)


def inertial_frames(device, n: int = INERTIAL_FRAMES, h: int = 480,
                    w: int = 640, kind: str = "orbit"):
    """(scene, [(gray, depth, T_wc, ts, (omega, acc, t))]): frames rendered
    on ``device``, their IMU samples as numpy."""
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    scene = SyntheticScene(h=h, w=w, device=device)
    return scene, list(scene.frames_with_imu(n, kind=kind))


def feed_inertial(system, frame) -> None:
    """One frame (gray, depth, T_wc, ts, samples) into ``system``."""
    gray, depth, _, ts, samples = frame
    system.track_rgbd(gray, depth, ts, imu=samples)


def make_system(cfg, device, with_sg: bool):
    """A ``SlamSystem`` on ``device``, with a ``SceneGraphManager``
    attached when ``with_sg``."""
    from visual_sgraphs_tpu_torch.scenegraph import SceneGraphManager
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem
    system = SlamSystem(cfg, device=device)
    if with_sg:
        system.scenegraph = SceneGraphManager(cfg.scenegraph, cfg.capacity,
                                              device=device)
    return system


def feed(system, frame) -> None:
    """One frame (gray, depth, sem, T_wc, ts) into ``system``: its
    semantics first when a scene graph is attached, then tracking."""
    gray, depth, sem, _, ts = frame
    if system.scenegraph is not None:
        system.scenegraph.provide_semantics(ts, sem)
    system.track_rgbd(gray, depth, ts)
