"""The keyframe program's map maintenance: the plain twins of K27 (found
stats, insertion), K28 (fusion's prologue and write-back) and K29 (point
and keyframe culling) against the reference's jitted functions, on seeded
small maps (``selfcheck.maint_cases``: K = 16, F = 64, N = 512, E = 8).

Integer and bool fields must match exactly; pt_pos, kf_pose and led_T_cp
(the back-projection and the ledger's T_cp, float32 in both packages)
within 1e-5 per component, as ``tests/test_torch_mapping.py``.  The same
cases run kernel against twin on the card (``selfcheck.run_maintenance``,
``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.slam import mapping as rmap
from visual_sgraphs_tpu.slam import map_state as rms
from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu.slam.frame import FrameObs as RFrame
from visual_sgraphs_tpu_torch import interop, selfcheck
from visual_sgraphs_tpu_torch.slam import mapping as pmap
from visual_sgraphs_tpu_torch.slam import tracking as ptrack

from torch_parity import one_torch_thread  # noqa: F401

SHAPES = dict(K=16, F=64, N=512, E=8, V=128)
N_LOCAL = 256
FLOAT_TOL = 1e-5
CULL = dict(min_obs=2, min_found_ratio=0.25)
REDUNDANCY = 0.9
CASES = ("first_keyframe", "free_slot_fold", "evict", "evict_full_ledger",
         "evict_alone", "evict_tie", "ties")


@pytest.fixture(scope="module")
def cases():
    return {c["name"]: c for c in selfcheck.maint_cases(**SHAPES)}


def _ref_map(d: dict):
    return rms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_maps(port, ref, what: str):
    for f in port._fields:
        p, r = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        if f in selfcheck.MAINT_FLOAT_FIELDS:
            np.testing.assert_allclose(p, r, rtol=0, atol=FLOAT_TOL,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{what}: {f}")


def _ref_stages(c: dict):
    """The reference's fold, insertion, fusion and two culls on case c."""
    rm = _ref_map(c["map"])
    if c["stats"] is not None:
        rm = rmap.apply_found_stats(rm, jnp.asarray(c["stats"]["slots"]),
                                    jnp.asarray(c["stats"]["vis"]))
    frame = RFrame(**{k: jnp.asarray(v) for k, v in c["frame"].items()})
    cam = jnp.asarray(c["cam"])
    r1, rk, rev = rmap.insert_keyframe(
        rm, frame, jnp.asarray(c["pose"]), jnp.asarray(c["slot_pt"]), cam,
        slot=jnp.asarray(c["slot"], jnp.int32))
    kf = jnp.asarray(c["kf"], jnp.int32)
    r2 = rmap.fuse_observations(r1, kf, cam, n_local=N_LOCAL)
    r3 = rmap.cull_points(r2, **CULL)
    r4, rc = rmap.cull_keyframes(r3, kf, REDUNDANCY)
    return (r1, int(rk), bool(rev)), r2, r3, (r4, int(rc))


def _port_stages(c: dict):
    ops = selfcheck.maint_operands(c, "cpu")
    p1, pk, pev = pmap.insert_keyframe(ops.m, ops.frame, ops.pose,
                                       ops.slot_pt, ops.cam, ops.slot,
                                       stats=ops.stats)
    p2 = pmap.fuse_observations(p1, ops.kf, ops.cam, n_local=N_LOCAL)
    p4, pc = pmap.cull_map(p2, ops.kf, redundancy=REDUNDANCY, **CULL)
    return ops, (p1, pk, bool(pev)), p2, (p4, int(pc))


@pytest.mark.parametrize("name", CASES)
def test_maintenance_matches_reference(cases, name):
    # insertion (with the serial program's fold), fusion and both culls,
    # stage by stage: the twins the CPU runs and the card's kernels match
    c = cases[name]
    (r1, rk, rev), r2, _, (r4, rc) = _ref_stages(c)
    ops, (p1, pk, pev), p2, (p4, pc) = _port_stages(c)
    assert (pk, pev) == (rk, rev)
    _assert_maps(p1, r1, "insert")
    _assert_maps(p2, r2, "fuse")
    _assert_maps(p4, r4, "cull")
    assert pc == rc
    # the map handed in is never modified
    _assert_maps(ops.m, _ref_map(c["map"]), "input")


@pytest.mark.parametrize("name", CASES)
def test_cull_map_is_cull_points_then_keyframes(cases, name):
    _, _, p2, (p4, pc) = _port_stages(cases[name])
    kf = cases[name]["kf"]
    p3 = pmap.cull_points(p2, **CULL)
    q4, qc = pmap.cull_keyframes(p3, kf, REDUNDANCY)
    for f in p4._fields:
        assert torch.equal(getattr(p4, f), getattr(q4, f)), f
    assert pc == int(qc)


def test_first_keyframe_point0_last_writer(cases):
    # an empty map: point 0 is free and goes to the first new keypoint, but
    # a later keypoint that allocates nothing writes point 0's old row back
    # (.at[safe].set, the last writer wins): the keyframe links point 0, a
    # point the map does not hold as valid.  Both packages agree.
    c = cases["first_keyframe"]
    (r1, _, _), *_ = _ref_stages(c)
    _, (p1, k, _), *_ = _port_stages(c)
    assert (p1.kf_obs_pt[k] == 0).any() and not bool(p1.pt_valid[0])
    assert (np.asarray(r1.kf_obs_pt)[k] == 0).any()
    assert not bool(r1.pt_valid[0])
    assert int(p1.n_pt) == int(r1.n_pt) > 0


def test_eviction_ledger_edges(cases):
    # a full ledger keeps its entries; a keyframe with no other valid
    # keyframe retires without an entry and keeps its points' first_kf;
    # two equidistant parents give the lower slot
    c = cases["evict_full_ledger"]
    _, (p1, _, ev), *_ = _port_stages(c)
    assert ev and int(p1.led_n) == SHAPES["E"]
    np.testing.assert_array_equal(p1.led_seq.numpy(), c["map"]["led_seq"])
    c = cases["evict_alone"]
    ops, (p1, k, ev), *_ = _port_stages(c)
    assert ev and int(p1.led_n) == int(c["map"]["led_n"])
    # only the new points' first_kf changes (to the slot itself)
    changed = p1.pt_first_kf != ops.m.pt_first_kf
    assert bool(changed.any()) and bool((p1.pt_first_kf[changed] == k).all())
    c = cases["evict_tie"]
    _, (p1, _, ev), *_ = _port_stages(c)
    n = int(p1.led_n) - 1
    seq = c["map"]["kf_seq"]
    assert ev and int(p1.led_parent_seq[n]) == seq[3] == seq[2] + 1
    assert seq[9] == seq[2] - 1


def test_cull_ties(cases):
    # keyframes 2-8 equally redundant: the first (2) retires; its two
    # equidistant parents (slots 3 and 9): the lower slot; the reference
    # agrees
    c = cases["ties"]
    *_, (r4, rc) = _ref_stages(c)
    _, _, _, (p4, pc) = _port_stages(c)
    seq = c["map"]["kf_seq"]
    assert pc == rc == 2
    n = int(p4.led_n) - 1
    assert int(p4.led_parent_seq[n]) == int(r4.led_parent_seq[n]) == seq[3]


def test_fuse_candidates_tied_counts(cases):
    # keyframe 1's covisibility counts tie over keyframes 2-8: the top 8
    # in lax.top_k's order (the lower slot first) and the compacted ids
    c = cases["ties"]
    (r1, _, _), *_ = _ref_stages(c)
    _, (p1, _, _), *_ = _port_stages(c)
    counts = rms.covisibility_counts(r1, jnp.asarray(1, jnp.int32))
    rc, rtop = jax.lax.top_k(counts, 8)
    assert len(set(np.asarray(rc)[:7].tolist())) == 1
    pmask = rms.observed_mask(r1, rtop, counts[rtop] > 0) & r1.pt_valid
    (rids,) = jnp.nonzero(pmask, size=N_LOCAL, fill_value=-1)
    ids, kp = pmap.fuse_candidates(p1, 1, N_LOCAL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(
        kp.valid.numpy(), np.asarray(r1.kf_kp_valid[1] & (r1.kf_obs_pt[1] < 0)))


def test_fuse_writeback_repeated_slot():
    # matched candidates that repeat a keyframe slot keep the largest id;
    # unmatched ones max -1 into the dump slot F - 1 (mapping.py:554-559)
    rng = np.random.default_rng(3)
    K, F, n = SHAPES["K"], SHAPES["F"], N_LOCAL
    obs = np.where(rng.uniform(size=(K, F)) < 0.5,
                   rng.integers(0, 512, (K, F)), -1).astype(np.int32)
    ids = np.sort(rng.choice(512, n, replace=False)).astype(np.int32)
    ok = rng.uniform(size=n) < 0.3
    slot = np.where(ok, rng.integers(0, 8, n), 0).astype(np.int64)
    assert len(np.unique(slot[ok])) < ok.sum()
    for kf in (0, 5):
        jit_ref = jax.jit(lambda o, i, k, s: o.at[kf].set(o[kf].at[
            jnp.where(k, s, F - 1)].max(jnp.where(k, i, -1))))
        ref = jit_ref(jnp.asarray(obs), jnp.asarray(ids), jnp.asarray(ok),
                      jnp.asarray(slot))
        out = pmap.fuse_writeback(torch.from_numpy(obs), kf,
                                  torch.from_numpy(ids), torch.from_numpy(ok),
                                  torch.from_numpy(slot))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cycle_fold_masks_rejected_frames(cases):
    # the cycle's fold: only the frames whose packed inlier count reaches
    # min_inliers add their found / visible ids (cycle_program.py:68-72)
    c = cases["free_slot_fold"]
    st = c["stats"]
    mi = selfcheck.MAINT_MIN_INLIERS
    acc = st["packeds"][:, 1] >= mi
    assert acc.any() and not acc.all()
    rm = rmap.apply_found_stats(
        _ref_map(c["map"]),
        jnp.where(jnp.asarray(acc)[:, None], st["slots"], -1),
        jnp.where(jnp.asarray(acc)[:, None], st["vis"], -1))
    pm = interop.map_from_numpy(c["map"])
    out = pmap.apply_found_stats(pm, torch.from_numpy(st["slots"]),
                                 torch.from_numpy(st["vis"]),
                                 torch.from_numpy(st["packeds"]), mi)
    np.testing.assert_array_equal(out.pt_found.numpy(), np.asarray(rm.pt_found))
    np.testing.assert_array_equal(out.pt_visible.numpy(),
                                  np.asarray(rm.pt_visible))


def test_serial_frame_stats(cases):
    # update_point_stats: one frame's row (tracking.py:517)
    c = cases["free_slot_fold"]
    st = c["stats"]
    track = dict(pose=c["pose"], slot_pt=st["slots"][0], vis_pt=st["vis"][0],
                 n_matches=np.int32(0), n_inliers=np.int32(0),
                 n_local_pts=np.int32(0))
    rm = rtrack.update_point_stats(
        _ref_map(c["map"]),
        rtrack.TrackResult(**{k: jnp.asarray(v) for k, v in track.items()}))
    pm = ptrack.update_point_stats(interop.map_from_numpy(c["map"]),
                                   interop.track_from_numpy(track))
    np.testing.assert_array_equal(pm.pt_found.numpy(), np.asarray(rm.pt_found))
    np.testing.assert_array_equal(pm.pt_visible.numpy(),
                                  np.asarray(rm.pt_visible))


def _np(m):
    return {f: getattr(m, f).numpy().copy() for f in m._fields}


@pytest.mark.parametrize("name", CASES)
def test_cull_kernel_single_pass_model(cases, name):
    # K29's arithmetic in numpy: one observation count, the bad points,
    # then every row's counts from the ORIGINAL links (a bad point is
    # invalid afterwards, so its links count for nothing either way) and
    # the first drop; equal to the twin's two passes on the unlinked map
    _, _, p2, (p4, pc) = _port_stages(cases[name])
    m = _np(p2)
    kf, N = cases[name]["kf"], m["pt_valid"].shape[0]
    obs, kp = m["kf_obs_pt"], m["kf_kp_valid"]
    live = kp & m["kf_valid"][:, None] & (obs >= 0)
    nobs = np.bincount(np.minimum(obs[live], N - 1), minlength=N)
    age = m["n_kf"] - m["pt_first_seq"]
    ratio = m["pt_found"].astype(np.float32) / np.maximum(
        m["pt_visible"].astype(np.float32), np.float32(1.0))
    low = (age <= 3) & (m["pt_visible"] >= 8) & (ratio < np.float32(0.25))
    bad = m["pt_valid"] & (((age >= 3) & (nobs < 2)) | low)
    valid = m["pt_valid"] & ~bad
    ge4 = ~bad & (nobs >= 4)
    safe = np.maximum(obs, 0)
    linked = obs >= 0
    ok = kp & linked & valid[safe]
    row_kf = obs[kf][kp[kf] & (obs[kf] >= 0)]
    member = np.zeros(N, bool)
    member[row_kf] = True
    member &= valid
    cov = (kp & linked & member[safe]).sum(1)
    cov = np.where(m["kf_valid"] & (np.arange(len(cov)) != kf), cov, 0)
    n_ok, n_red = ok.sum(1), (ok & ge4[safe]).sum(1)
    cand = (cov > 0) & m["kf_valid"]
    cand[[0, kf]] = False
    r = n_red.astype(np.float32) / np.maximum(n_ok, 1).astype(np.float32)
    drop = cand & (r > np.float32(REDUNDANCY)) & (n_ok > 0)
    first = int(np.argmax(drop)) if drop.any() else -1
    assert first == pc
    np.testing.assert_array_equal(p4.pt_valid.numpy()[~bad], valid[~bad])
    assert not p4.pt_valid.numpy()[bad].any()
    np.testing.assert_array_equal(p4.kf_obs_pt.numpy(),
                                  np.where(linked & bad[safe], -1, obs))


@pytest.mark.parametrize("name", CASES)
def test_insert_kernel_rank_model(cases, name):
    # K27's allocation in numpy: the free point of ascending rank r takes
    # the r-th new keypoint while r < min(new, free); point 0 takes its
    # row only from the last keypoint whose safe id is 0; equal to the
    # twin's cumsum allocation and last-writer scatter
    c = cases[name]
    ops, (p1, k, _), *_ = _port_stages(c)
    if c["stats"] is not None:
        m0 = pmap.apply_found_stats(ops.m, *ops.stats)
    else:
        m0 = ops.m
    m = _np(m0)
    fr = {f: getattr(ops.frame, f).numpy() for f in ops.frame._fields}
    slot_pt = ops.slot_pt.numpy()
    free = ~m["pt_valid"] & (m["n_kf"] - m["pt_freed_seq"] >= 3)
    new = fr["valid"] & (fr["depth"] > 0) & (slot_pt < 0)
    free_ids, new_kp = np.flatnonzero(free), np.flatnonzero(new)
    n_alloc = min(len(free_ids), len(new_kp))
    alloc_of = dict(zip(free_ids[:n_alloc], new_kp[:n_alloc]))
    order = np.cumsum(new) - 1
    alloc = new & (order < len(free_ids))
    safe0 = ~alloc | (new & (order == 0) & bool(free[0]))
    last0 = int(np.flatnonzero(safe0).max()) if safe0.any() else -1
    won = {p: i for p, i in alloc_of.items() if p != 0 or i == last0}
    valid = p1.pt_valid.numpy()
    for p, i in alloc_of.items():
        assert p1.kf_obs_pt[k, i] == p
        assert valid[p] == (p in won or bool(m["pt_valid"][p]))
    assert int(p1.n_pt) - int(m["n_pt"]) == n_alloc
    np.testing.assert_array_equal(p1.kf_obs_pt.numpy()[k][~alloc],
                                  slot_pt[~alloc])
