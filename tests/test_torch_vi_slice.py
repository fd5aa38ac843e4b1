"""The inertial slice as a whole: 72 ``arc`` frames at 240x320 with their
IMU samples through the reference SlamSystem and the port's
(``Sensor.IMU_RGBD``, 300 features, 32 keyframes / 4096 points, the
default ``ImuConfig``): the serial path, the gravity / velocity / bias
initialisation, then K6 with its pose prior, the per-frame visual-inertial
solve (K20's twin) and the VI local BA (also alone, from the reference's
state carried across before its second VI local BA).  The reference runs
with JAX in float32, the precision it integrates and solves in; with the
conftest's float64 the reference's own trajectory moves by up to
0.05 m."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu import config as rcfg
from visual_sgraphs_tpu.core import geometry as rgeo
from visual_sgraphs_tpu.inertial import vi_ba as rvba
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.slam import SlamSystem as RefSystem
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.inertial import vi_ba as pvba
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = 72


def vi_config(scene) -> rcfg.SystemConfig:
    return rcfg.SystemConfig(
        sensor=rcfg.Sensor.IMU_RGBD, camera=scene.cam,
        orb=rcfg.OrbConfig(n_features=tp.N_FEATURES),
        capacity=rcfg.CapacityConfig(max_keyframes=32, max_points=4096),
        imu=rcfg.ImuConfig(),
        mapping=rcfg.MappingConfig(lba_iters=6, lba_interval=2,
                                   cull_interval=2))


def vi_frames():
    """[(gray, depth, T_wc, ts, samples)] rendered by the reference."""
    def build():
        scene = SyntheticScene(h=tp.H, w=tp.W)
        return [(np.asarray(g, np.float32), np.asarray(d, np.float32),
                 np.asarray(T, np.float32), ts, s)
                for g, d, T, ts, s in scene.frames_with_imu(N_FRAMES,
                                                            kind="arc")]
    return SyntheticScene(h=tp.H, w=tp.W), tp.cached(
        f"vi_frames_arc{N_FRAMES}", build)


def _reference_run():
    """The reference's run (float32), with its state captured just before
    its second VI local BA."""
    scene, frames = vi_frames()
    cfg = vi_config(scene)
    out = {"cfg": cfg}
    with jax.enable_x64(False):
        ref = RefSystem(cfg)
        local_ba = ref.imu.local_ba
        calls = []

        def spy(system, kf, **kw):
            calls.append(kf)
            if len(calls) == 2:
                out["mid"] = dict(
                    kf=int(kf), map=jax.tree.map(np.asarray, system.map),
                    imu=jax.tree.map(np.asarray, ref.imu.state))
            return local_ba(system, kf, **kw)

        ref.imu.local_ba = spy
        init = None
        for i, (g, d, _, ts, s) in enumerate(frames):
            ref.track_rgbd(g, d, ts, imu=s)
            if init is None and ref.imu.initialized:
                init = (i, int(ref.map.n_kf))
        out.update(positions=ref.positions(), tracked=ref.tracked_mask(),
                   n_kf=int(ref.map.n_kf), init=init, n_vi_lba=len(calls))
    return out


def reference_run():
    return tp.cached(f"vi_reference_run{N_FRAMES}", _reference_run)


def vi_reference_state():
    """The reference's map and inertial state just before its second VI
    local BA, with the keyframe and the configuration."""
    run = reference_run()
    return {**run["mid"], "cfg": run["cfg"]}


@pytest.fixture(scope="module")
def runs():
    scene, frames = vi_frames()
    ref = reference_run()
    port = PortSystem(tp.port_config(ref["cfg"]), device="cpu")
    init = None
    for i, (g, d, _, ts, s) in enumerate(frames):
        port.track_rgbd(g, d, ts, imu=s)
        if init is None and port.imu.initialized:
            init = (i, port.n_kf_host)
    gt = np.stack([f[2][4:7] for f in frames])
    return ref, port, init, gt


def test_initialises_with_the_reference(runs):
    # the same frame and keyframe count
    ref, port, init, _ = runs
    assert port.imu.initialized
    assert init == ref["init"], (init, ref["init"])
    assert init[1] >= 8


def test_vi_stages_ran(runs):
    # at least 2 VI local BAs and 8 accepted per-frame solves after the
    # initialisation, as in the reference
    ref, port, _, _ = runs
    kfs = port.events.of_kind("keyframe")
    n_vi_lba = sum(bool(k["vi_ba"]) for k in kfs)
    assert n_vi_lba >= 2 and ref["n_vi_lba"] >= 2
    assert n_vi_lba == ref["n_vi_lba"]
    assert sum(e["accepted"] for e in port.events.of_kind("vi_solve")) >= 8


def test_positions_and_keyframes_match_reference(runs):
    # per-frame camera centres within 0.02 m of the reference's, the same
    # keyframe count, every frame tracked in both
    ref, port, _, _ = runs
    p = port.positions()
    assert p.shape == ref["positions"].shape == (N_FRAMES, 3)
    np.testing.assert_allclose(p, ref["positions"], rtol=0, atol=0.02)
    assert port.tracked_mask().all() and ref["tracked"].all()
    assert int(port.map.n_kf) == ref["n_kf"]


def test_ate(runs):
    # both under the reference's visual-inertial gate
    # (tests/test_inertial.py:269)
    ref, port, _, gt = runs
    r_ate = float(rgeo.ate_rmse(jnp.asarray(ref["positions"]),
                                jnp.asarray(gt))[0])
    p_ate = float(pgeo.ate_rmse(torch.from_numpy(port.positions()),
                                torch.from_numpy(gt))[0])
    assert r_ate < 0.08 and p_ate < 0.08, (r_ate, p_ate)


def test_readbacks(runs):
    # one packed vector a frame (two when the track retries), one inlier
    # count a frame after the initialisation, one read an initialisation
    # attempt
    _, port, init, _ = runs
    n_vi = port.events.count("vi_solve")
    assert n_vi >= N_FRAMES - init[0] - 8
    assert port.host_readbacks <= 2 * N_FRAMES + n_vi + 8


def test_vi_local_ba():
    # the reference's VI local BA from its own state, carried across: the
    # window's poses within 1e-4, its points within 1e-3 m, velocities
    # within 1e-3 m/s, biases within 1e-4 (6 float32 LM iterations with a
    # Schur complement over ~2000 points, summed in another order)
    s = vi_reference_state()
    kf = s["kf"]
    cfg = s["cfg"]
    K = np.asarray(cfg.camera.K)
    bf = np.float32(cfg.camera.bf)
    T_bc = np.float32(cfg.imu.T_bc)
    with jax.enable_x64(False):
        r_map, r_imu, r_cost = rvba.vi_local_ba(
            jax.tree.map(jnp.asarray, s["map"]),
            jax.tree.map(jnp.asarray, s["imu"]), jnp.asarray(kf, jnp.int32),
            jnp.asarray(K), jnp.asarray(bf), jnp.asarray(T_bc), n_window=10,
            iters=6)
        r_map = tp.to_np(r_map)
        r_vel, r_bg = np.asarray(r_imu.vel), np.asarray(r_imu.bias_g)
        r_ba = np.asarray(r_imu.bias_a)
    imu = interop.imu_state_from_numpy(
        {**s["imu"]._asdict(), "preint": s["imu"].preint._asdict()})
    p_map, p_imu, p_cost = pvba.vi_local_ba(
        interop.map_from_numpy(tp.to_np(s["map"])), imu, kf, tp.t(K),
        torch.tensor(bf), tp.t(T_bc), n_window=10, iters=6)
    kfs = np.arange(kf - 9, kf + 1)
    kfs = kfs[kfs >= 0]
    np.testing.assert_allclose(p_map.kf_pose.numpy()[kfs],
                               r_map["kf_pose"][kfs], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_map.pt_pos.numpy(), r_map["pt_pos"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_imu.vel.numpy(), r_vel, rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_imu.bias_g.numpy(), r_bg, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p_imu.bias_a.numpy(), r_ba, rtol=0,
                               atol=1e-4)
    # the map moved: the solve did something
    assert np.abs(r_map["kf_pose"][kfs] - np.asarray(
        s["map"].kf_pose)[kfs]).max() > 1e-6
    assert float(p_cost) == pytest.approx(float(r_cost), rel=1e-3)


def test_port_config_round_trip():
    cfg = vi_config(SyntheticScene(h=tp.H, w=tp.W))
    assert dataclasses.asdict(tp.port_config(cfg)) == dataclasses.asdict(cfg)
