"""The scene-graph slice as a whole: 12 reference-rendered RGB-D frames with
semantics through the reference SlamSystem and the port's, each with a
SceneGraphManager attached (plane detection and association, rooms,
semantic point refinement, plane covisibility, scene-graph local BA; serial
path, loops off).  The port's manager is given the reference's RANSAC
samples, and the reference reads each keyframe's own depth image, the
corrected pairing the port takes (``KeyframeDepthReference``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import geometry as rgeo
from visual_sgraphs_tpu.scenegraph.manager import SceneGraphManager as RefMgr
from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager as PortMgr,
)
from visual_sgraphs_tpu_torch.scenegraph.manager import sign_duplicates
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import KeyframeDepthReference, ReferenceHypotheses
from torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = 12


@pytest.fixture(scope="module")
def runs():
    scene, frames = tp.semantic_frames(N_FRAMES)
    cfg = tp.slice_config(scene)
    cfg = dataclasses.replace(cfg, scenegraph=dataclasses.replace(
        cfg.scenegraph, plane_covis_enabled=True, refine_map_points=True))
    ref = KeyframeDepthReference(cfg)
    ref.scenegraph = RefMgr(cfg.scenegraph, cfg.capacity)
    pcfg = tp.port_config(cfg)
    port = PortSystem(pcfg, device="cpu")
    port.scenegraph = PortMgr(pcfg.scenegraph, pcfg.capacity, device="cpu",
                              hypotheses=ReferenceHypotheses())
    for g, d, s, _, ts in frames:
        ref.scenegraph.provide_semantics(ts, s)
        ref.track_rgbd(g, d, ts)
        port.scenegraph.provide_semantics(ts, s)
        port.track_rgbd(g, d, ts)
    gt = np.stack([T[4:7] for _, _, _, T, _ in frames])
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


def test_planes_match_reference_up_to_sign(runs):
    # every reference plane, taken up to sign, matches a port plane within
    # 0.02 and the reverse; where both have passed plane_min_votes their
    # classes agree; the port holds no sign-duplicate pair
    ref, port, _ = runs
    rp, pp = ref.scenegraph.planes(), port.scenegraph.planes()
    assert len(rp["coeffs"]) >= 2 and len(pp["coeffs"]) >= 2

    def nearest(c, table):
        d = np.minimum(np.abs(table - c).max(1), np.abs(table + c).max(1))
        return int(np.argmin(d)), float(d.min())

    for a, b in ((rp, pp), (pp, rp)):
        for c, cls in zip(a["coeffs"], a["semantic"]):
            j, d = nearest(c, b["coeffs"])
            assert d < 0.02, (c, b["coeffs"])
            if cls >= 0 and b["semantic"][j] >= 0:
                assert cls == b["semantic"][j]
    assert not sign_duplicates(pp["coeffs"])


def test_scenegraph_ran_and_observations_agree(runs):
    ref, port, _ = runs
    kfs = port.events.of_kind("keyframe")
    assert any(k["lba"] for k in kfs)
    assert int(port.scenegraph.state.n_obs) == int(ref.scenegraph.state.n_obs)
    # the lagged host mirror of n_obs came through the keyframe board
    assert port.scenegraph.n_obs_host == int(port.scenegraph.state.n_obs)
    assert port.host_readbacks <= 3 * N_FRAMES
