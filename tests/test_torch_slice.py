"""The slice as a whole: the same 12 reference-rendered RGB-D frames
through the reference SlamSystem and the port's (tracking + keyframe
insertion + fusion + culling + local BA, serial path, loops and scene
graph off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import geometry as rgeo
from visual_sgraphs_tpu.slam import SlamSystem as RefSystem
from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = 12


@pytest.fixture(scope="module")
def runs():
    scene, frames = tp.reference_frames(N_FRAMES, kind="arc")
    cfg = tp.slice_config(scene)
    ref = RefSystem(cfg)
    port = PortSystem(tp.port_config(cfg), device="cpu")
    for g, d, _, ts in frames:
        ref.track_rgbd(g, d, ts)
        port.track_rgbd(g, d, ts)
    gt = np.stack([T[4:7] for _, _, T, _ in frames])
    return ref, port, gt


def test_positions_match_reference(runs):
    # per-frame camera centres within 0.01 m of the reference's
    ref, port, _ = runs
    r, p = ref.positions(), port.positions()
    assert p.shape == r.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(p, r, rtol=0, atol=0.01)
    assert port.tracked_mask().all() and ref.tracked_mask().all()


def test_keyframes_and_ate(runs):
    ref, port, gt = runs
    assert int(port.map.n_kf) == int(ref.map.n_kf) >= 2
    r_ate = float(rgeo.ate_rmse(jnp.asarray(ref.positions()),
                                jnp.asarray(gt))[0])
    p_ate = float(pgeo.ate_rmse(torch.from_numpy(port.positions()),
                                torch.from_numpy(gt))[0])
    assert r_ate < 0.05 and p_ate < 0.05, (r_ate, p_ate)


def test_slice_ran_lba_and_cull(runs):
    _, port, _ = runs
    kfs = port.events.of_kind("keyframe")
    assert any(k["lba"] for k in kfs) and any(k["cull"] for k in kfs)
    # the serial path reads back about one packed vector per frame
    assert port.host_readbacks <= 3 * N_FRAMES


@pytest.fixture(scope="module")
def recovery_runs():
    # frames 6 and 7 blanked (no image, no depth): tracking loses both (the
    # second on the serial path, which the lost state takes), and frame 8
    # is tracked again from the lost state, which makes a recovery
    # keyframe with the generic LM local BA in both packages
    scene, frames = tp.reference_frames(N_FRAMES, kind="arc")
    cfg = tp.slice_config(scene)
    ref = RefSystem(cfg)
    port = PortSystem(tp.port_config(cfg), device="cpu")
    ref_recoveries = []
    insert = ref._insert_keyframe

    def spy(frame, res, n_inl=0):
        ref_recoveries.append(len(ref.trajectory))
        return insert(frame, res, n_inl)

    ref._insert_keyframe = spy
    for i, (g, d, _, ts) in enumerate(frames):
        if i in (6, 7):
            g, d = np.zeros_like(g), np.zeros_like(d)
        ref.track_rgbd(g, d, ts)
        port.track_rgbd(g, d, ts)
    return ref, port, ref_recoveries


def test_recovery_keyframe_matches_reference(recovery_runs):
    # the same frame recovers in both; tracked centres within the slice's
    # 0.01 m; the same keyframe count
    ref, port, ref_recoveries = recovery_runs
    port_recoveries = port.events.of_kind("recovery_keyframe")
    assert len(port_recoveries) == len(ref_recoveries) == 1
    np.testing.assert_array_equal(port.tracked_mask(), ref.tracked_mask())
    assert not port.tracked_mask()[6:8].any() and port.tracked_mask()[8:].all()
    both = port.tracked_mask()
    np.testing.assert_allclose(port.positions()[both], ref.positions()[both],
                               rtol=0, atol=0.01)
    assert int(port.map.n_kf) == int(ref.map.n_kf)
