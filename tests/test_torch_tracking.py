"""Port parity of tracking: the K6 twin (pose-only Gauss-Newton) on a
seeded problem, and the whole per-frame track on a reference map snapshot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu_torch.slam import tracking as ptrack

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

K = np.array([260.0, 260.0, 159.5, 119.5], np.float32)
BF = np.float32(20.8)


def _gn_problem(rng, M=512, outlier_frac=0.2):
    T_true = np.asarray(rlie.se3_exp(jnp.asarray(
        (rng.normal(size=6) * [0.2, 0.1, 0.2, 0.05, 0.1, 0.05]).astype(
            np.float32))), np.float32)
    p_cam = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                      rng.uniform(1.0, 6.0, M)], -1).astype(np.float32)
    T_wc = np.asarray(rlie.se3_inverse(jnp.asarray(T_true)))
    xw = np.asarray(rlie.se3_apply(jnp.asarray(T_wc), jnp.asarray(p_cam)),
                    np.float32)
    uv = np.stack([K[0] * p_cam[:, 0] / p_cam[:, 2] + K[2],
                   K[1] * p_cam[:, 1] / p_cam[:, 2] + K[3]], -1)
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    out = rng.uniform(size=M) < outlier_frac
    uv[out] += rng.uniform(-40, 40, size=(out.sum(), 2)).astype(np.float32)
    depth = (p_cam[:, 2] * (1 + rng.normal(size=M) * 0.005)).astype(
        np.float32)
    depth[rng.uniform(size=M) < 0.1] = -1.0  # depthless rows: no stereo row
    valid = rng.uniform(size=M) > 0.05
    T_init = np.asarray(rlie.se3_boxplus(jnp.asarray(T_true), jnp.asarray(
        (rng.normal(size=6) * 0.02).astype(np.float32))), np.float32)
    return T_init, xw, uv, valid, depth


def test_pose_only_gn_twin(rng):
    # pose within 1e-4 per component: float32 solve of the same normal
    # equations, sums and the 6x6 solve ordered differently; inlier masks
    # agree on >= 99% of rows (rows at the chi2 edge may flip)
    T_init, xw, uv, valid, depth = _gn_problem(rng)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2)
    rT, rin = rtrack.pose_only_gn(
        jnp.asarray(T_init), jnp.asarray(xw), jnp.asarray(uv),
        jnp.asarray(valid), jnp.asarray(K), depth=jnp.asarray(depth),
        bf=jnp.asarray(BF), **kw)
    pT, pin = ptrack.pose_only_gn(
        tp.t(T_init), tp.t(xw), tp.t(uv), tp.t(valid), tp.t(K),
        depth=tp.t(depth), bf=torch.tensor(BF), **kw)
    np.testing.assert_allclose(pT.numpy(), np.asarray(rT), rtol=0, atol=1e-4)
    agree = np.mean(pin.numpy() == np.asarray(rin))
    assert agree >= 0.99, agree
    assert 0.6 * len(valid) < pin.numpy().sum() < 0.9 * len(valid)


def test_pose_only_gn_twin_mono(rng):
    # the same without the stereo row, final-gate-only schedule
    T_init, xw, uv, valid, _ = _gn_problem(rng, outlier_frac=0.0)
    rT, rin = rtrack.pose_only_gn(jnp.asarray(T_init), jnp.asarray(xw),
                                  jnp.asarray(uv), jnp.asarray(valid),
                                  jnp.asarray(K), iters=12)
    pT, pin = ptrack.pose_only_gn(tp.t(T_init), tp.t(xw), tp.t(uv),
                                  tp.t(valid), tp.t(K), iters=12)
    np.testing.assert_allclose(pT.numpy(), np.asarray(rT), rtol=0, atol=1e-4)
    assert np.mean(pin.numpy() == np.asarray(rin)) >= 0.99


@pytest.fixture(scope="module")
def snap():
    return tp.snapshot(10)


@pytest.mark.parametrize("retry", [False, True])
def test_track_frame_full_on_snapshot(snap, retry):
    # slot_pt / vis_pt / packed counters exact (integer outputs of the same
    # matches), pose within 1e-4; ``retry`` starts from a prediction 0.5 m
    # off so the first attempt fails and the wide re-track runs
    cfg = snap["cfg"]
    T_last = snap["last_pose"]
    T_pred = np.asarray(rlie.se3_normalize(rlie.se3_multiply(
        jnp.asarray(snap["velocity"]), jnp.asarray(T_last))), np.float32)
    if retry:
        T_pred = T_pred.copy()
        T_pred[4] += 0.5
    kw = dict(n_window=10, fx_radius=15.0, fine_radius=7.0,
              img_wh=(cfg.camera.width, cfg.camera.height))
    bf = np.float32(cfg.camera.bf)
    r_res, r_map, r_packed = rtrack.track_frame_full(
        snap["map"], snap["frame"], jnp.asarray(T_pred), jnp.asarray(T_last),
        jnp.asarray(snap["ref_kf"], jnp.int32), jnp.asarray(cfg.camera.K),
        jnp.asarray(15, jnp.int32), cam_bf=jnp.asarray(bf), **kw)
    p_res, p_map, p_packed = ptrack.track_frame_full(
        tp.port_map(snap["map"]), tp.port_frame(snap["frame"]),
        tp.t(T_pred), tp.t(T_last), snap["ref_kf"], tp.t(cfg.camera.K), 15,
        cam_bf=torch.tensor(bf), **kw)
    r_packed = np.asarray(r_packed)
    assert r_packed[3] == float(retry)
    np.testing.assert_array_equal(p_packed, r_packed)
    assert r_packed[1] >= 15
    np.testing.assert_array_equal(p_res.slot_pt.numpy(),
                                  np.asarray(r_res.slot_pt))
    np.testing.assert_array_equal(p_res.vis_pt.numpy(),
                                  np.asarray(r_res.vis_pt))
    np.testing.assert_allclose(p_res.pose.numpy(), np.asarray(r_res.pose),
                               rtol=0, atol=1e-4)
    for f in ("pt_found", "pt_visible"):
        np.testing.assert_array_equal(getattr(p_map, f).numpy(),
                                      np.asarray(getattr(r_map, f)))


def test_local_point_table_on_snapshot(snap):
    # exact: the same compact ascending id table (sync-free compaction)
    r_ids, _, r_ok = rtrack._local_point_table(
        snap["map"], jnp.asarray(snap["ref_kf"], jnp.int32), 10, 4096)
    p = ptrack._local_point_table(
        tp.port_map(snap["map"]), snap["ref_kf"], 10, 4096)
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r_ok))
    assert p.valid.numpy().sum() > 100
    assert int(p.n_pts) == int(np.asarray(r_ok).sum())
