"""Shared set-up of the PyTorch-port parity tests (not a test module).

Builds the slice configuration for both packages and a mid-stream map
snapshot of the reference, so port functions run on exactly the
reference's state (carried across as numpy).  The snapshot and the
rendered semantic frames are built once per test run and shared by the
test processes through ``build/test_cache`` (keyed by a digest of the
reference's sources and this file, under a file lock), as are the
reference's compiled programs (JAX's persistent compilation cache,
``build/test_cache/jax``).
"""

import dataclasses
import fcntl
import hashlib
import os
import pickle
from pathlib import Path

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.slam.frame import make_frame_obs
from visual_sgraphs_tpu.slam.map_state import empty_map
from visual_sgraphs_tpu.slam.mapping import insert_keyframe
from visual_sgraphs_tpu.slam import SlamSystem as RefSystem
from visual_sgraphs_tpu.slam.tracking import track_frame_full
from visual_sgraphs_tpu_torch import interop

H, W, N_FEATURES = 240, 320, 300
REPO = Path(__file__).resolve().parent.parent
CACHE_DIR = REPO / "build" / "test_cache"

# The reference's jitted programs compile in every test process, the same
# ones in several modules (the slice, scan and scene-graph programs): their
# executables are kept on disk beside the cached runs, so that a process
# after the first loads them.  A reference test module compiles while it
# is imported, before this one is: resetting the cache lets the directory
# apply to the rest of the process.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
compilation_cache.set_cache_dir(str(CACHE_DIR / "jax"))
compilation_cache.reset_cache()


def _digest() -> str:
    h = hashlib.sha256(jax.__version__.encode())
    for f in sorted((REPO / "visual_sgraphs_tpu").rglob("*.py")):
        h.update(f.read_bytes())
    h.update(Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def cached(name: str, build):
    """``build()``, computed by the first test process that asks and
    loaded from disk by the others (they wait on its lock meanwhile)."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    path = CACHE_DIR / f"{name}_{_digest()}.pkl"
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = build()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, path)
        return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops are small; one intra-op thread per test worker
    avoids oversubscribing the cores the parallel test run shares.  The
    BLAS pools (numpy's, and the one the reference's LAPACK calls use) get
    one thread too: OpenBLAS threads spin while they wait, and with six
    test workers on an eight-core CPU the reference's joint BA ran some
    thirty times slower than alone."""
    # the reference's LAPACK calls go through scipy's OpenBLAS, which
    # loads on first use: load it now so that the limit reaches it
    import scipy.linalg  # noqa: F401
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def slice_config(scene) -> rcfg.SystemConfig:
    """The slice at test size: RGB-D, 300 features, 32 keyframes / 4096
    points, serial path, loops and scene graph off."""
    return rcfg.SystemConfig(
        sensor=rcfg.Sensor.RGBD,
        camera=scene.cam,
        orb=rcfg.OrbConfig(n_features=N_FEATURES),
        capacity=rcfg.CapacityConfig(max_keyframes=32, max_points=4096),
        mapping=rcfg.MappingConfig(lba_iters=6, lba_interval=2,
                                   cull_interval=2),
    )


def port_config(cfg: rcfg.SystemConfig):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def reference_frames(n: int, kind: str = "arc"):
    """[(gray, depth, T_wc, ts)] rendered by the reference, as numpy."""
    scene = SyntheticScene(h=H, w=W)
    return scene, [(np.asarray(g, np.float32), np.asarray(d, np.float32),
                    np.asarray(T, np.float32), ts)
                   for g, d, T, ts in scene.frames(n, kind=kind)]


def semantic_frames(n: int = 12, kind: str = "arc"):
    """(scene, [(gray, depth, sem, T_wc, ts)]) rendered by the reference
    with semantics, as numpy."""
    def build():
        scene = SyntheticScene(h=H, w=W)
        return [(np.asarray(g, np.float32), np.asarray(d, np.float32),
                 np.asarray(s, np.int32), np.asarray(T, np.float32), ts)
                for g, d, s, T, ts in scene.frames_with_semantics(n, kind)]
    return SyntheticScene(h=H, w=W), cached(f"semantic_frames_{kind}{n}",
                                            build)


def to_np(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def snapshot(n_frames: int = 10):
    """The mid-stream reference map of ``build_snapshot``, built once per
    test run."""
    return cached(f"snapshot{n_frames}", lambda: build_snapshot(n_frames))


def scan_snapshot(n_map: int = 10, n_scan: int = 16):
    """``build_snapshot(n_map)`` on an ``n_map + n_scan``-frame render,
    with the ``n_scan`` frames after the map's as numpy (gray, depth,
    T_wc, ts) under ``"later"``, built once per test run."""
    return cached(f"scan_snapshot{n_map}_{n_scan}",
                  lambda: build_snapshot(n_map, n_map + n_scan))


def build_snapshot(n_frames: int = 10, n_render: int | None = None):
    """A mid-stream reference map, built with the reference's own
    functions: frame 0 is the origin keyframe, frames 1.. are tracked with
    ``track_frame_full`` (point stats folded in), and frame
    ``n_frames // 2`` becomes a second keyframe.  Returns the map, the
    configuration, frame ``n_frames``'s observation (reference FrameObs)
    and the tracker's last pose / velocity / reference keyframe; with
    ``n_render`` (frames rendered, default ``n_frames + 1``) also the
    rendered frames from ``n_frames`` on (``"later"``)."""
    scene, frames = reference_frames(n_render or n_frames + 1)
    cfg = slice_config(scene)
    K = jnp.asarray(cfg.camera.K)
    bf = jnp.asarray(np.float32(cfg.camera.bf))
    obs = [make_frame_obs(jnp.asarray(g), jnp.asarray(d), ts, cfg.camera,
                          cfg.orb) for g, d, _, ts in frames[:n_frames + 1]]
    F = cfg.orb.n_features
    m = empty_map(cfg.capacity, cfg.orb)
    T_last = vel = rlie.se3_identity()
    m, _, _ = insert_keyframe(m, obs[0], T_last,
                              jnp.full((F,), -1, jnp.int32), K,
                              slot=jnp.asarray(0, jnp.int32))
    ref_kf = 0
    for i in range(1, n_frames):
        T_pred = rlie.se3_normalize(rlie.se3_multiply(vel, T_last))
        res, m, _ = track_frame_full(
            m, obs[i], T_pred, T_last, jnp.asarray(ref_kf, jnp.int32), K,
            jnp.asarray(15, jnp.int32), n_window=10, fx_radius=15.0,
            fine_radius=7.0, cam_bf=bf,
            img_wh=(cfg.camera.width, cfg.camera.height))
        pose = rlie.se3_normalize(res.pose)
        vel = rlie.se3_normalize(rlie.se3_multiply(pose,
                                                   rlie.se3_inverse(T_last)))
        T_last = pose
        if i == n_frames // 2:
            m, _, _ = insert_keyframe(m, obs[i], pose, res.slot_pt, K,
                                      slot=jnp.asarray(1, jnp.int32))
            ref_kf = 1
    out = dict(cfg=cfg, map=m, frame=obs[n_frames],
               last_pose=np.asarray(T_last, np.float32),
               velocity=np.asarray(vel, np.float32), ref_kf=ref_kf)
    if n_render is not None:
        out["later"] = frames[n_frames:]
    return out


def port_map(ref_map):
    return interop.map_from_numpy(to_np(ref_map))


def port_frame(ref_frame):
    return interop.frame_from_numpy(to_np(ref_frame))


def t(x):
    return torch.from_numpy(np.asarray(x))


class KeyframeDepthReference(RefSystem):
    """The reference SlamSystem with each keyframe's scene-graph stages fed
    that keyframe's own depth image.  Unmodified, the reference resolves a
    keyframe one frame late and pairs its pose with the next frame's depth
    (ROADMAP.md, known reference defects); the port pairs them correctly,
    and a parity test against the defect would lock it in."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self._depth_at = {}

    def track_rgbd(self, gray, depth, timestamp, imu=None):
        self._depth_at[float(timestamp)] = jnp.asarray(depth)
        return super().track_rgbd(gray, depth, timestamp, imu)

    def _insert_keyframe_fused(self, frame, res, n_inl, ts=None):
        if ts is not None:
            self._last_depth_img = self._depth_at[float(ts)]
        return super()._insert_keyframe_fused(frame, res, n_inl, ts=ts)


class ReferenceHypotheses:
    """The reference manager's sample stream: one key split per keyframe,
    one randint draw per extraction round."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n_det, n_hyp, n_cloud):
        self.key, sub = jax.random.split(self.key)
        return np.stack([
            np.asarray(jax.random.randint(k, (n_hyp, 3), 0, n_cloud))
            for k in jax.random.split(sub, n_det)]).astype(np.int32)
