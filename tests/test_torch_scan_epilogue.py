"""K25's twins on the CPU: the tracking scan's per-frame bookkeeping.

``scan_epilogue_torch`` (the frame entry), ``inlier_tail_torch`` (the
serial step's tail entry) and ``scan_prologue_torch`` (the first frame's
prediction) against the reference's arithmetic, jitted: the inlier tail of
``visual_sgraphs_tpu/slam/tracking.py::_track_frame_impl`` (:318-333) and
the scan step of ``make_frame_scan`` (:475-510), on the seeded attempts of
``selfcheck.scan_epilogue_inputs`` (4096 local ids, 1000 keypoint slots)
with the retry taken and accepted, not taken, and taken but rejected.
Integers and decisions exact, poses within POSE_TOL.  The whole scan
against the reference's is ``tests/test_torch_pipeline.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.slam import tracking

from torch_parity import one_torch_thread  # noqa: F401

# float32 on both sides; XLA fuses the pose algebra's elementwise chain
# and may round it in another order than torch's eager ops
POSE_TOL = 1e-6


def _np(t):
    return t.numpy()


def _ref_tail(ok, slot, inl, ids, F):
    """The reference's inlier tail (tracking.py:318-333)."""
    keep = ok & inl
    slot_pt = jnp.full((F,), -1, jnp.int32).at[
        jnp.where(keep, slot, F - 1)
    ].max(jnp.where(keep, ids, -1).astype(jnp.int32), mode="drop")
    return slot_pt, jnp.sum(keep.astype(jnp.int32))


@jax.jit
def _ref_step(att1, att2, ids, n_pts, kf_base, T_prev, min_inliers):
    """The reference's scan step after the two attempts
    (tracking.py:480-510) and the next step's prediction (:475)."""
    F = 1000
    res = []
    for ok, slot, vis, n_match, T, inl in (att1, att2):
        slot_pt, n_inl = _ref_tail(ok, slot, inl, ids, F)
        res.append((T, slot_pt, vis, n_match, n_inl, n_pts))
    need_retry = res[0][4] < min_inliers
    sel = tuple(jnp.where(need_retry, b, a) for a, b in zip(*res))
    accepted = sel[4] >= min_inliers
    new_pose = rlie.se3_normalize(sel[0])
    pose_sel = jnp.where(accepted, new_pose, T_prev)
    vel_new = rlie.se3_normalize(
        rlie.se3_multiply(new_pose, rlie.se3_inverse(T_prev)))
    vel_sel = jnp.where(accepted, vel_new, rlie.se3_identity())
    T_rel = rlie.se3_normalize(
        rlie.se3_multiply(pose_sel, rlie.se3_inverse(kf_base)))
    packed = jnp.stack([
        sel[3].astype(jnp.float32), sel[4].astype(jnp.float32),
        sel[5].astype(jnp.float32), need_retry.astype(jnp.float32)])
    T_pred = rlie.se3_normalize(rlie.se3_multiply(vel_sel, pose_sel))
    return sel, T_rel, packed, jnp.stack([T_pred, pose_sel, vel_sel])


def _attempt_np(a):
    return (_np(a.fine.ok), _np(a.fine.slot), _np(a.fine.vis_pt),
            _np(a.fine.n_match), _np(a.pose), _np(a.inliers))


@pytest.mark.parametrize("case,retry,accept", selfcheck.SCAN_CASES)
def test_scan_epilogue_twin_matches_reference_step(case, retry, accept):
    ops = selfcheck.scan_epilogue_inputs("cpu", retry, accept)
    a1, a2, table, kf_base, min_inliers, state, F = ops
    out = selfcheck._scan_run(tracking.scan_epilogue_torch, ops)
    sel, T_rel, packed, new_state = _ref_step(
        _attempt_np(a1), _attempt_np(a2), _np(table.ids), _np(table.n_pts),
        _np(kf_base), _np(state[1]), min_inliers)
    r = out.results
    i = 1
    assert bool(packed[3]) == retry
    assert bool(sel[4] >= min_inliers) == accept
    for got, want in ((r.slot_pt[i], sel[1]), (r.vis_pt[i], sel[2]),
                      (r.n_matches[i], sel[3]), (r.n_inliers[i], sel[4]),
                      (r.n_local_pts[i], sel[5]), (out.packeds[i], packed)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(r.pose[i]), np.asarray(sel[0]))
    for got, want in ((out.T_rels[i], T_rel), (out.state, new_state)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=POSE_TOL)
    # the other row is not written
    assert (out.packeds[0] == -7).all() and (r.slot_pt[0] == -7).all()


@pytest.mark.parametrize("which", [0, 1])
def test_inlier_tail_twin_matches_reference_tail(which):
    ops = selfcheck.scan_epilogue_inputs("cpu", True)
    a, table, F = ops[which], ops[2], ops[6]
    slot_pt, n_inl, packed = tracking.inlier_tail_torch(a, table, F,
                                                        bool(which))
    ref_slot, ref_n = jax.jit(_ref_tail, static_argnums=4)(
        _np(a.fine.ok), _np(a.fine.slot), _np(a.inliers), _np(table.ids), F)
    np.testing.assert_array_equal(_np(slot_pt), np.asarray(ref_slot))
    assert int(n_inl) == int(ref_n) > 0
    np.testing.assert_array_equal(_np(packed), np.array(
        [int(a.fine.n_match), int(ref_n), int(table.n_pts), which],
        np.float32))


def test_scan_prologue_twin_matches_reference_prediction():
    rng = np.random.default_rng(3)
    T, v = selfcheck._random_poses(rng, 2)
    state = torch.empty((3, 7))
    tracking.scan_prologue_torch(torch.from_numpy(T), torch.from_numpy(v),
                                 state)
    want = jax.jit(lambda v, T: rlie.se3_normalize(
        rlie.se3_multiply(v, T)))(v, T)
    np.testing.assert_allclose(_np(state[0]), np.asarray(want), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_array_equal(_np(state[1]), T)
    np.testing.assert_array_equal(_np(state[2]), v)


def test_scan_outputs_rows_are_views_of_two_buffers():
    out = tracking.scan_outputs(8, 1000, 4096, "cpu")
    r = out.results
    assert r.pose.shape == (8, 7) and r.slot_pt.shape == (8, 1000)
    assert r.vis_pt.shape == (8, 4096) and r.n_inliers.shape == (8,)
    assert out.T_rels.shape == (8, 7) and out.packeds.shape == (8, 4)
    assert out.state.shape == (3, 7)
    floats = {t.untyped_storage().data_ptr()
              for t in (r.pose, out.T_rels, out.packeds, out.state)}
    ints = {t.untyped_storage().data_ptr()
            for t in (r.slot_pt, r.vis_pt, r.n_matches, r.n_inliers,
                      r.n_local_pts)}
    assert len(floats) == 1 and len(ints) == 1
    assert all(t.is_contiguous() for t in (*r, out.T_rels, out.packeds,
                                           out.state))
