"""The scene-graph slice's recovery keyframe against the reference's: the
12 reference-rendered frames of ``test_torch_sg_slice.py`` with frames 6
and 7 blanked, through both packages with a SceneGraphManager attached
(the port's given the reference's RANSAC samples, the reference reading
each keyframe's own depth image, ``KeyframeDepthReference``)."""

import dataclasses

import numpy as np
import pytest

from visual_sgraphs_tpu.scenegraph.manager import SceneGraphManager as RefMgr
from visual_sgraphs_tpu_torch.scenegraph.manager import (
    SceneGraphManager as PortMgr,
)
from visual_sgraphs_tpu_torch.slam.system import SlamSystem as PortSystem

import torch_parity as tp
from torch_parity import KeyframeDepthReference, ReferenceHypotheses
from torch_parity import one_torch_thread  # noqa: F401

N_FRAMES = 12


@pytest.fixture(scope="module")
def recovery_runs():
    # frames 6 and 7 blanked (no image, no depth): tracking loses both and
    # frame 8 makes a recovery keyframe, with the scene graph's joint BA
    # on the LM engine once planes are observed
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
    ref_recoveries = []
    insert = ref._insert_keyframe

    def spy(frame, res, n_inl=0):
        # without loop closing the reference never refreshes its host
        # mirror of n_obs (it reads it back only on the place query's
        # board), so its recovery keyframe would always take the plain LM
        # BA; the port's mirror rides every keyframe board (ROADMAP.md
        # queue 3).  Hand the reference the value the port's mirror holds.
        ref.scenegraph.n_obs_host = int(ref.scenegraph.state.n_obs)
        ref_recoveries.append(ref.scenegraph.n_obs_host)
        return insert(frame, res, n_inl)

    ref._insert_keyframe = spy
    for i, (g, d, s, _, ts) in enumerate(frames):
        if i in (6, 7):
            g, d = np.zeros_like(g), np.zeros_like(d)
        ref.scenegraph.provide_semantics(ts, s)
        ref.track_rgbd(g, d, ts)
        port.scenegraph.provide_semantics(ts, s)
        port.track_rgbd(g, d, ts)
    return ref, port, ref_recoveries


def test_recovery_keyframe_matches_reference(recovery_runs):
    # the same frame recovers in both through the joint BA (plane
    # observations held); tracked centres within 0.01 m; the same keyframe
    # and plane-observation counts
    ref, port, ref_recoveries = recovery_runs
    recoveries = port.events.of_kind("recovery_keyframe")
    assert len(recoveries) == len(ref_recoveries) == 1
    assert ref_recoveries[0] > 0 and recoveries[0]["joint_ba"]
    np.testing.assert_array_equal(port.tracked_mask(), ref.tracked_mask())
    assert not port.tracked_mask()[6:8].any() and port.tracked_mask()[8:].all()
    both = port.tracked_mask()
    np.testing.assert_allclose(port.positions()[both], ref.positions()[both],
                               rtol=0, atol=0.01)
    assert int(port.map.n_kf) == int(ref.map.n_kf)
    assert int(port.scenegraph.state.n_obs) == int(ref.scenegraph.state.n_obs)
