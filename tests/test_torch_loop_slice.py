"""The loop-closing slice as a whole: 96 two-lap ``orbit2`` frames at
240x320 (the camera of ``test_pipeline.py``'s bench harness), 600 ORB
features, the ``bench.py`` configuration at ``pipeline_depth=1`` with the
scene graph off: place recognition, Sim3 verification, pose-graph
correction, global BA after each loop, and relocalisation of lost frames,
through the reference SlamSystem and the port's.  The port's loop closer
is handed the reference's RANSAC draws (``samples=``), so both verify and
relocalise on the same hypotheses.  The reference's run is built once and
shared through ``build/test_cache``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.core import geometry as rgeo
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.place import loop_closer as rlc, pgo as rpgo
from visual_sgraphs_tpu.slam import SlamSystem as RefSystem
from visual_sgraphs_tpu_torch.core import lie as plie
from visual_sgraphs_tpu_torch.place import loop_closer as plc, pgo as ppgo
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

N_FRAMES, H, W, N_FEATURES = 96, 240, 320, 600
FPS = 30.0  # SyntheticScene.frames' timestamps
# The two packages part before any loop: keyframe 3 is inserted with 83
# tracked inliers in the reference and 81 in the port (the loop-free
# path's known float divergence, ROADMAP.md queue 3), the maps drift
# apart, and keyframe 12's place query is the first loop decision that
# differs.  The reference then closes keyframe 14 <-> 1 and the port,
# whose keyframe-14 verification falls two inliers short of the gate,
# closes 15 <-> 1 a keyframe later, each correcting its own drift (0.13
# and 0.08 in the tangent norm).  Seen: positions within 0.075 m before
# the first loop, 90 % of frames within 0.058 m, the largest gap 0.128 m
# after the relocalisations (the reference loses frames 58-59, the port
# 60-61, each relocalising against its own keyframe).
PRE_LOOP_TOL = 0.08  # every frame before either package's first loop
P90_TOL = 0.07  # nine frames in ten
POS_TOL = 0.15  # every frame both packages track
def loop_config():
    cam = rcfg.CameraConfig(fx=517.3 * W / 640, fy=516.5 * H / 480,
                            cx=318.6 * W / 640, cy=255.3 * H / 480,
                            width=W, height=H)
    return rcfg.SystemConfig(
        sensor=rcfg.Sensor.RGBD, camera=cam,
        orb=rcfg.OrbConfig(n_features=N_FEATURES),
        capacity=rcfg.CapacityConfig(max_keyframes=128, max_points=32768),
        mapping=rcfg.MappingConfig(lba_iters=6, lba_interval=2,
                                   cull_interval=2),
        loop_closing=True,
        place=rcfg.PlaceConfig(vocab_min_keyframes=4, consistency=1,
                               min_gap=8, gba_after_loop=True))


def loop_frames():
    cfg = loop_config()
    scene = SyntheticScene(cam=cfg.camera, h=H, w=W)
    return tp.cached(f"loop_frames_{N_FRAMES}", lambda: [
        (np.asarray(g, np.float32), np.asarray(d, np.float32),
         np.asarray(T, np.float32), ts)
        for g, d, T, ts in scene.frames(N_FRAMES, kind="orbit2")])


def summary(system, gt) -> dict:
    pos = np.asarray(system.positions())
    tracked = np.asarray(system.tracked_mask())
    ev = system.events
    return dict(
        pos=pos, tracked=tracked,
        loops=[tuple(int(x) for x in e["cand"])
               for e in ev.of_kind("loop_closed")],
        loop_frames=[int(round(e["ts_kf"] * FPS))
                     for e in ev.of_kind("loop_verified")
                     if e["drift"] >= 0.02],
        n_gba=ev.count("global_ba"), n_reloc=ev.count("reloc"),
        reloc=[int(e["cand"]) for e in ev.of_kind("reloc")],
        n_kf=int(system.map.n_kf),
        ate=float(rgeo.ate_rmse(jnp.asarray(pos[tracked]),
                                jnp.asarray(gt[tracked]))[0]))


class CorrectionRecorder:
    """Records each loop correction of a package's pose graph: the loop
    (i = candidate, j = current keyframe), its measured Sim3 and the
    keyframe poses before the PGO and after ``correct_map``."""

    def __init__(self, pgo_module):
        self.pgo, self.calls = pgo_module, []

    def __enter__(self):
        optimize, correct = (self.pgo.optimize_essential_graph,
                             self.pgo.correct_map)

        def optimize_spy(kf_pose, kf_valid, edges, loop_i, loop_j,
                         S_loop_ji, **kw):
            self.calls.append(dict(i=int(loop_i), j=int(loop_j),
                                   S_loop_ji=np.asarray(S_loop_ji),
                                   before=np.asarray(kf_pose)))
            return optimize(kf_pose, kf_valid, edges, loop_i=loop_i,
                            loop_j=loop_j, S_loop_ji=S_loop_ji, **kw)

        def correct_spy(m, res, *args, **kw):
            out = correct(m, res, *args, **kw)
            if self.calls:
                self.calls[-1]["after"] = np.asarray(out.kf_pose)
            return out

        self._saved = optimize, correct
        self.pgo.optimize_essential_graph = optimize_spy
        self.pgo.correct_map = correct_spy
        return self

    def __exit__(self, *exc):
        (self.pgo.optimize_essential_graph,
         self.pgo.correct_map) = self._saved

    def drifts(self, loop_drift, sim3_inverse, to_array) -> list:
        """(pre, post) loop drift of every real loop correction (the
        reference's compile warm-up solves a loop of a keyframe with
        itself)."""
        out = []
        for c in self.calls:
            if c["i"] == c["j"]:
                continue
            S = sim3_inverse(to_array(c["S_loop_ji"]))
            out.append(tuple(
                float(loop_drift(to_array(c[k]), c["j"], c["i"], S))
                for k in ("before", "after")))
        return out


def reference_run() -> dict:
    ref = RefSystem(loop_config())
    frames = loop_frames()
    with CorrectionRecorder(rpgo) as rec:
        for g, d, _, ts in frames:
            ref.track_rgbd(g, d, ts)
    out = summary(ref, np.stack([T[4:7] for _, _, T, _ in frames]))
    out["drifts"] = rec.drifts(rlc._loop_drift, rlie.sim3_inverse,
                               jnp.asarray)
    return out


class ReferenceSamples:
    """The reference's RANSAC draws for a key and a validity mask: Sim3
    samples by jax.random.choice (place/sim3_ransac.py:46-50), PnP picks by
    jax.random.categorical (place/pnp.py:91-94)."""

    def __call__(self, kind: str, key: int, valid: torch.Tensor):
        v = jnp.asarray(valid.cpu().numpy())
        k = jax.random.PRNGKey(key)
        if kind == "sim3":
            w = v.astype(jnp.float32)
            return np.asarray(jax.random.choice(
                k, v.shape[0], shape=(256, 3), replace=True,
                p=w / jnp.maximum(jnp.sum(w), 1.0)))
        logits = jnp.where(v, 0.0, -1e9)
        return np.asarray(jax.random.categorical(
            k, logits[None, None, :], axis=-1, shape=(192, 6)))


@pytest.fixture(scope="module")
def runs():
    ref = tp.cached(f"loop_slice_ref_drifts_{N_FRAMES}", reference_run)
    frames = loop_frames()
    port = PortSystem(tp.port_config(loop_config()), device="cpu")
    port.loop_closer.samples = ReferenceSamples()
    with CorrectionRecorder(ppgo) as rec:
        for g, d, _, ts in frames:
            port.track_rgbd(g, d, ts)
    gt = np.stack([T[4:7] for _, _, T, _ in frames])
    out = summary(port, gt)
    out["drifts"] = rec.drifts(plc._loop_drift, plie.sim3_inverse,
                               torch.from_numpy)
    return ref, out, port


def test_same_loops_gba_and_relocalisations(runs):
    ref, port, _ = runs
    assert len(port["loops"]) == len(ref["loops"]) >= 1
    for (pk, pc), (rk, rc) in zip(port["loops"], ref["loops"]):
        assert pc == rc and abs(pk - rk) <= 1, (port["loops"], ref["loops"])
    assert port["n_gba"] == ref["n_gba"] >= 1
    assert port["n_reloc"] == ref["n_reloc"]
    assert abs(port["n_kf"] - ref["n_kf"]) <= 1


def test_positions_and_ate(runs):
    ref, port, _ = runs
    assert ref["ate"] <= 0.16 and port["ate"] <= 0.16, (ref["ate"],
                                                       port["ate"])
    assert abs(ref["ate"] - port["ate"]) <= 0.02, (ref["ate"], port["ate"])
    assert port["tracked"].sum() == ref["tracked"].sum() >= 90
    both = port["tracked"] & ref["tracked"]
    gap = np.abs(port["pos"] - ref["pos"]).max(axis=1)
    first_loop = min(port["loop_frames"][0], ref["loop_frames"][0])
    assert gap[:first_loop][both[:first_loop]].max() <= PRE_LOOP_TOL
    assert np.percentile(gap[both], 90) <= P90_TOL
    np.testing.assert_allclose(port["pos"][both], ref["pos"][both], rtol=0,
                               atol=POS_TOL)


def test_loop_corrections_close_their_loops(runs):
    # each package's correction takes its own loop drift (0.13 in the
    # reference, 0.08 in the port) to under 1e-3: a weak or missing
    # correction in the port would leave its drift standing
    ref, port, _ = runs
    assert len(port["drifts"]) == len(ref["drifts"]) == len(port["loops"])
    for pre, post in port["drifts"] + ref["drifts"]:
        assert pre >= 0.02 and post <= 1e-3, (port["drifts"], ref["drifts"])


def test_readbacks_bounded(runs):
    # the detection scalars ride the keyframe board; a verification adds
    # one read a keyframe later, a relocalisation a few
    _, _, port = runs
    assert port.host_readbacks <= 3 * N_FRAMES
    assert port.loop_closer.vocab is not None
    assert port.loop_closer.vocab.n_words >= 64
