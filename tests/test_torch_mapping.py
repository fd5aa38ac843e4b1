"""Port parity of the keyframe path on a reference map snapshot: insert ->
fuse -> cull (integer tables exact), then the analytic local BA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.optim import fast_ba as rba
from visual_sgraphs_tpu.parallel import dist_ba as rdist
from visual_sgraphs_tpu.slam import mapping as rmap
from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu_torch.optim import fast_ba as pba
from visual_sgraphs_tpu_torch.parallel import dist_ba as pdist
from visual_sgraphs_tpu_torch.slam import mapping as pmap

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

INT_FIELDS = ("kf_valid", "kf_seq", "kf_obs_pt", "kf_kp_valid", "pt_valid",
              "pt_first_kf", "pt_first_seq", "pt_freed_seq", "pt_visible",
              "pt_found", "led_seq", "led_parent_seq", "led_n", "n_kf",
              "n_pt")


@pytest.fixture(scope="module")
def keyframe_case():
    """Reference snapshot + the next frame tracked against it, run through
    insert -> fuse -> cull in the reference."""
    snap = tp.snapshot(10)
    cfg = snap["cfg"]
    m = snap["map"]
    T_last = jnp.asarray(snap["last_pose"])
    res, _, _ = rtrack.track_frame_full(
        m, snap["frame"], T_last, T_last,
        jnp.asarray(snap["ref_kf"], jnp.int32), jnp.asarray(cfg.camera.K),
        jnp.asarray(15, jnp.int32), n_window=10, fx_radius=15.0,
        fine_radius=7.0, cam_bf=jnp.asarray(np.float32(cfg.camera.bf)),
        img_wh=(cfg.camera.width, cfg.camera.height))
    slot = int(np.flatnonzero(~np.asarray(m.kf_valid))[0])
    K = jnp.asarray(cfg.camera.K)
    m1, kf, _ = rmap.insert_keyframe(m, snap["frame"], res.pose, res.slot_pt,
                                     K, slot=jnp.asarray(slot, jnp.int32))
    m2 = rmap.fuse_observations(m1, kf, K)
    m3 = rmap.cull_points(m2, min_obs=2, min_found_ratio=0.25)
    m4, culled = rmap.cull_keyframes(m3, kf, 0.9)
    return dict(snap=snap, res=res, slot=slot, stages=(m1, m2, m3, m4),
                culled=int(culled))


def _assert_map_equal(port, ref, float_tol=1e-5):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    # float fields: written from the same float32 inputs; 1e-5 covers the
    # back-projection's rounding
    for f in ("pt_pos", "kf_pose", "led_T_cp"):
        np.testing.assert_allclose(getattr(port, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=float_tol, err_msg=f)


def test_insert_fuse_cull_exact(keyframe_case):
    snap, res = keyframe_case["snap"], keyframe_case["res"]
    cfg = snap["cfg"]
    K = tp.t(cfg.camera.K)
    pm = tp.port_map(snap["map"])
    m1, kf, evicted = pmap.insert_keyframe(
        pm, tp.port_frame(snap["frame"]), tp.t(res.pose),
        tp.t(res.slot_pt), K, slot=keyframe_case["slot"])
    assert kf == keyframe_case["slot"] and not bool(evicted)
    m2 = pmap.fuse_observations(m1, kf, K)
    m3 = pmap.cull_points(m2, min_obs=2, min_found_ratio=0.25)
    m4, culled = pmap.cull_keyframes(m3, kf, 0.9)
    for port, ref in zip((m1, m2, m3, m4), keyframe_case["stages"]):
        _assert_map_equal(port, ref)
    assert int(culled) == keyframe_case["culled"]
    # the insert seeded new points
    assert int(keyframe_case["stages"][0].n_pt) > int(snap["map"].n_pt)


def test_retire_keyframe_ledger(keyframe_case):
    # exact: retiring a valid keyframe writes the same ledger entry
    m = keyframe_case["stages"][3]
    r = rmap.retire_keyframe(m, jnp.asarray(1, jnp.int32), jnp.asarray(True))
    p = pmap.retire_keyframe(tp.port_map(m), 1, torch.tensor(True))
    _assert_map_equal(p, r)
    assert int(r.led_n) == int(m.led_n) + 1


BA_FLOAT_FIELDS = ("kf_pose", "pt_pos", "kf_uv", "kf_depth")


@pytest.mark.parametrize("port_dtype", ["float32", "float64"])
def test_fast_local_ba(keyframe_case, port_dtype):
    # poses within 1e-4, points within 1e-3 after 6 iterations, held
    # against the reference's float64 solve of the same map.  The port runs
    # at the slice's float32 and at float64.  Two float32 solves are not
    # compared with each other: the reduced system is ill-conditioned enough
    # that the reference's own float32 points lie ~7e-4 from its float64
    # points on this snapshot, and a second float32 solve summed in another
    # order adds its own rounding of that size.
    m4 = keyframe_case["stages"][3]
    cfg = keyframe_case["snap"]["cfg"]
    kf = keyframe_case["slot"]
    bf = np.float32(cfg.camera.bf)
    r64 = m4._replace(**{f: getattr(m4, f).astype(jnp.float64)
                         for f in BA_FLOAT_FIELDS})
    r, r_cost = rba.fast_local_ba(
        r64, jnp.asarray(kf, jnp.int32),
        jnp.asarray(cfg.camera.K, jnp.float64), jnp.asarray(bf, jnp.float64),
        n_window=10, iters=6)
    dt = getattr(torch, port_dtype)
    pm = tp.port_map(m4)
    pm = pm._replace(**{f: getattr(pm, f).to(dt) for f in BA_FLOAT_FIELDS})
    p, p_cost = pba.fast_local_ba(pm, kf, tp.t(cfg.camera.K).to(dt),
                                  torch.tensor(bf, dtype=dt), n_window=10,
                                  iters=6)
    np.testing.assert_allclose(p.kf_pose.numpy(), np.asarray(r.kf_pose),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.pt_pos.numpy(), np.asarray(r.pt_pos),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(p_cost), float(r_cost), rtol=1e-3)
    moved = np.abs(np.asarray(r.kf_pose) - np.asarray(m4.kf_pose)).max()
    assert moved > 1e-6  # the solve did move the window


@pytest.mark.parametrize("port_dtype", ["float32", "float64"])
def test_local_ba_generic(keyframe_case, port_dtype):
    # the recovery keyframe's LM windowed BA (points eliminated), 6
    # iterations: the rule of test_fast_local_ba against the reference's
    # float64 solve
    m4 = keyframe_case["stages"][3]
    cfg = keyframe_case["snap"]["cfg"]
    kf = keyframe_case["slot"]
    bf = np.float32(cfg.camera.bf)
    r64 = m4._replace(**{f: getattr(m4, f).astype(jnp.float64)
                         for f in BA_FLOAT_FIELDS})
    r, r_stats = rmap.local_ba(
        r64, jnp.asarray(kf, jnp.int32),
        jnp.asarray(cfg.camera.K, jnp.float64), jnp.asarray(bf, jnp.float64),
        n_window=10, iters=6)
    dt = getattr(torch, port_dtype)
    pm = tp.port_map(m4)
    pm = pm._replace(**{f: getattr(pm, f).to(dt) for f in BA_FLOAT_FIELDS})
    p, p_cost = pmap.local_ba(pm, kf, tp.t(cfg.camera.K).to(dt),
                              torch.tensor(bf, dtype=dt), n_window=10,
                              iters=6)
    np.testing.assert_allclose(p.kf_pose.numpy(), np.asarray(r.kf_pose),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.pt_pos.numpy(), np.asarray(r.pt_pos),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(p_cost), float(r_stats.cost1),
                               rtol=1e-3)
    assert float(r_stats.cost1) < float(r_stats.cost0)


def test_group_observations_exact(rng):
    # exact: integer tables and copied coordinates
    n_obs, n_pt, max_obs = 400, 60, 5
    kf = rng.integers(0, 11, n_obs).astype(np.int32)
    pt = rng.integers(-1, n_pt + 2, n_obs).astype(np.int32)
    uvr = rng.normal(size=(n_obs, 3)).astype(np.float32)
    valid = rng.uniform(size=n_obs) > 0.2
    r = rdist.group_observations(jnp.asarray(kf), jnp.asarray(pt),
                                 jnp.asarray(uvr), jnp.asarray(valid),
                                 n_pt, max_obs)
    p = pdist.group_observations(tp.t(kf), tp.t(pt), tp.t(uvr), tp.t(valid),
                                 n_pt, max_obs)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _nonzero_case(kind: str, n: int = 500):
    rng = np.random.default_rng(7)
    if kind == "empty":
        return np.zeros(n, bool), 40
    if kind == "full":
        return np.ones(n, bool), 40
    if kind == "more_than_size":
        return rng.uniform(size=n) < 0.5, 100
    return rng.uniform(size=n) < 0.1, 80


@pytest.mark.parametrize("kind", ["empty", "full", "more_than_size",
                                  "random"])
def test_compact_true_matches_nonzero(kind):
    # K7's twin against jnp.nonzero(mask, size=size, fill_value=-1): exact
    from visual_sgraphs_tpu_torch.slam.map_state import compact_true
    mask, size = _nonzero_case(kind)
    (r,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=-1)
    p = compact_true(tp.t(mask), size)
    np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_group_observations_overflow_exact(rng):
    # exact with heavy overflow: 30 landmarks each seen ~13 times against
    # max_obs = 4, so most entries are dropped and n_dropped counts them
    n_obs, n_pt, max_obs = 500, 30, 4
    kf = rng.integers(0, 11, n_obs).astype(np.int32)
    pt = rng.integers(0, n_pt, n_obs).astype(np.int32)
    uvr = rng.normal(size=(n_obs, 3)).astype(np.float32)
    valid = rng.uniform(size=n_obs) > 0.2
    r = rdist.group_observations(jnp.asarray(kf), jnp.asarray(pt),
                                 jnp.asarray(uvr), jnp.asarray(valid),
                                 n_pt, max_obs)
    p = pdist.group_observations(tp.t(kf), tp.t(pt), tp.t(uvr), tp.t(valid),
                                 n_pt, max_obs)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(p[3]) > n_obs // 2
