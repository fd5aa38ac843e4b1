"""Parity of K11's keyframe-program entry (the place query with the
database's validity sync and the insertion, ``place_query_insert``) and
K5's NN-ratio matcher (``match_nn_ratio``) with the reference, on the CPU
twins, at small sizes (K = 32 rows, W = 64 words, <= 277 descriptors);
and numpy models of the two kernels' select and merge rules against the
twins.  The cases are ``selfcheck.place_cases`` / ``nn_cases``, which the
card tests (``test_torch_gpu.py``) run through the kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.features import match as rmatch
from visual_sgraphs_tpu.place import database as rdb
from visual_sgraphs_tpu.place import loop_closer as rlc
from visual_sgraphs_tpu.place import vocab as rvocab
from visual_sgraphs_tpu_torch import interop, selfcheck
from visual_sgraphs_tpu_torch.features import match as pmatch
from visual_sgraphs_tpu_torch.place import database as pdb
from visual_sgraphs_tpu_torch.place import loop_closer as plc

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

N = np.asarray
PLACE = {c["name"]: c for c in selfcheck.place_cases()}
NN = {c["name"]: c for c in selfcheck.nn_cases()}
BIG = 10_000


def reference_detect(c):
    """The reference's ``_detect_program`` after its BoW vector and masks:
    the validity sync, ``detect_candidates``, ``add_keyframe``, then
    ``best_covisible_score`` on the database after the insertion."""
    db = rdb.build_db(jnp.asarray(c["bows"]), jnp.asarray(c["db_valid"]))
    db = db._replace(valid=db.valid & jnp.asarray(c["kf_valid"]))
    q = jnp.asarray(c["q"])
    ids, scores = rdb.detect_candidates(db, q, jnp.asarray(c["exclude"]),
                                        min_common_ratio=c["ratio"],
                                        top_n=c["top_n"])
    new_db = rdb.add_keyframe(db, jnp.asarray(c["kf"], jnp.int32), q)
    ref = rdb.best_covisible_score(new_db, q, jnp.asarray(c["covis"]))
    extra = (np.zeros(1, np.float32) if c["extra"] is None
             else c["extra"].astype(np.float32))
    packed = np.concatenate([[float(ref)], N(ids).astype(np.float32),
                             N(scores), [float(N(db.valid).sum())], extra])
    return new_db, packed.astype(np.float32)


@pytest.mark.parametrize("name", list(PLACE))
def test_place_query_insert_matches_reference(name):
    # ids, valid count, extra and the database after the insertion exact;
    # scores and the covisible reference score within 1e-6
    c = PLACE[name]
    new_db, rp = reference_detect(c)
    db, q, exclude, covis, kf_valid, kf, extra = \
        selfcheck.place_case_operands(c, "cpu")
    out_db, pp = pdb.place_query_insert(db, q, exclude, covis, kf_valid, kf,
                                        extra, c["ratio"], c["top_n"])
    n = c["top_n"]
    pp = pp.numpy()
    assert pp.shape == rp.shape
    np.testing.assert_array_equal(pp[1:1 + n], rp[1:1 + n])
    np.testing.assert_array_equal(pp[1 + 2 * n:], rp[1 + 2 * n:])
    np.testing.assert_allclose(pp[1 + n:1 + 2 * n], rp[1 + n:1 + 2 * n],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pp[0], rp[0], rtol=0, atol=1e-6)
    for k in ("bow", "has_word", "valid"):
        np.testing.assert_array_equal(getattr(out_db, k).numpy(),
                                      N(getattr(new_db, k)))
    # the database is updated in place
    assert out_db.valid is db.valid and out_db.bow is db.bow
    if name == "all_excluded":
        assert (pp[1:1 + n] == -1).all()
    if name == "ties":
        # four equal rows at the top: the lower indices first
        assert list(pp[1:1 + n]) == [3, 9, 20]


def test_covisible_reference_score_ignores_the_insertion():
    # covisibility_counts zeroes the keyframe's own entry, so covis[kf] is
    # false and the reference score reads the same before the insertion
    # (the port, and the kernel) as after it (the reference); were
    # covis[kf] true, the two orders would part
    snap = tp.snapshot(10)
    m, pm = snap["map"], tp.port_map(snap["map"])
    for kf in range(int(N(m.kf_valid).sum())):
        _, rcov = rlc._exclusion_mask(m, jnp.asarray(kf, jnp.int32), 10)
        _, pcov = plc._exclusion_mask(pm, kf, 10)
        np.testing.assert_array_equal(pcov.numpy(), N(rcov))
        assert not bool(pcov[kf])
    c = dict(PLACE["reused_slot"])
    c["covis"] = c["covis"].copy()
    c["covis"][c["kf"]] = True
    _, rp = reference_detect(c)
    _, pp = pdb.place_query_insert(
        *selfcheck.place_case_operands(c, "cpu"), c["ratio"], c["top_n"])
    assert rp[0] == pytest.approx(float(np.minimum(c["q"], c["q"]).sum()))
    assert pp[0] < rp[0] - 1e-3


def test_detect_program_on_snapshot():
    # the keyframe program's place query on the mid-stream map (BoW rows
    # from the reference's tree, keyframe 1's slot reused: it holds
    # keyframe 0's row): packed and database as the reference's
    snap = tp.snapshot(10)
    m = snap["map"]
    desc = N(m.kf_desc[:2]).reshape(-1, 32)[N(m.kf_kp_valid[:2]).reshape(-1)]
    tree = rvocab.fit_vocab(desc, 8, 2, seed=0)
    bows = np.array(rlc._backfill_bow(tree, m.kf_desc, m.kf_kp_valid))
    bows[1] = bows[0]
    rdb_ = rdb.build_db(jnp.asarray(bows), m.kf_valid)
    extra = jnp.asarray([5], jnp.int32)
    r_db, rp = rlc._detect_program(m, rdb_, tree, jnp.asarray(1, jnp.int32),
                                   10, 3, extra)
    ptree = interop.vocab_from_numpy(
        {"centers": [N(x) for x in tree.centers], "idf": N(tree.idf)})
    p_db, pp = plc._detect_program(
        tp.port_map(m), interop.placedb_from_numpy(tp.to_np(rdb_)), ptree,
        1, 10, 3, torch.tensor([5], dtype=torch.int32))
    rp, pp = N(rp), pp.numpy()
    np.testing.assert_array_equal(pp[1:4], rp[1:4])
    np.testing.assert_array_equal(pp[7:], rp[7:])
    np.testing.assert_allclose(pp[[0, 4, 5, 6]], rp[[0, 4, 5, 6]], rtol=0,
                               atol=1e-6)
    assert rp[0] > 0  # keyframe 0 is covisible: a reference score
    np.testing.assert_allclose(p_db.bow.numpy(), N(r_db.bow), rtol=0,
                               atol=1e-6)
    for k in ("has_word", "valid"):
        np.testing.assert_array_equal(getattr(p_db, k).numpy(),
                                      N(getattr(r_db, k)))


def reference_nn(c):
    """The reference's ``match_nn_ratio`` on a case; it refuses one target
    (``lax.top_k`` of 2), so b is padded there with an invalid column,
    whose distance 10000 is the second of every row."""
    db_, vb, ab = c["desc_b"], c["valid_b"], c["angle_b"]
    if db_.shape[0] == 1:
        db_ = np.concatenate([db_, db_])
        vb = np.concatenate([vb, [False]])
        ab = np.concatenate([ab, ab])
    kw = dict(ratio=c["ratio"], mutual=c["mutual"])
    if c["angles"]:
        kw.update(angle_a=jnp.asarray(c["angle_a"]), angle_b=jnp.asarray(ab))
    m, d = rmatch.match_nn_ratio(jnp.asarray(c["desc_a"]),
                                 jnp.asarray(c["valid_a"]),
                                 jnp.asarray(db_), jnp.asarray(vb), **kw)
    return N(m), N(d)


@pytest.mark.parametrize("name", list(NN))
def test_match_nn_ratio_cases_match_reference(name):
    # exact: matches and distances
    c = NN[name]
    da, va, db_, vb, aa, ab = selfcheck.nn_case_operands(c, "cpu")
    kw = dict(ratio=c["ratio"], mutual=c["mutual"])
    if c["angles"]:
        kw.update(angle_a=aa, angle_b=ab)
    pm, pd = pmatch.match_nn_ratio(da, va, db_, vb, **kw)
    rm, rd = reference_nn(c)
    np.testing.assert_array_equal(pm.numpy(), rm)
    np.testing.assert_array_equal(pd.numpy(), rd)
    n_matched = int((rm >= 0).sum())
    if name == "all_a_invalid":
        assert n_matched == 0
    elif name == "tie":
        # the best at columns 3 and 7: the lower column, second = best
        assert rm[2] == 3 and rd[2] == 0
    elif name != "nb1":
        assert n_matched > 20


def _hamming(da, db_, va, vb):
    bits_a = np.unpackbits(da, axis=1).astype(np.int32)
    bits_b = np.unpackbits(db_, axis=1).astype(np.int32)
    d = (bits_a[:, None, :] != bits_b[None, :, :]).sum(-1)
    return np.where(va[:, None] & vb[None, :], d, BIG)


def _lane_best2(d):
    """The kernel's row scan: lane l walks columns l, l + 32, ... in order
    with a running (best, column, second), then a shuffle tree merges the
    lanes (best of the union by (distance, column), second = min(winner's
    second, loser's best)).  Returns lane 0's (nn, best, second)."""
    big = np.iinfo(np.int32).max
    n_a, n_b = d.shape
    b1 = np.full((n_a, 32), big, np.int64)
    i1 = np.full((n_a, 32), big, np.int64)
    b2 = np.full((n_a, 32), big, np.int64)
    for t in range(n_b):
        lane, x = t % 32, d[:, t]
        lt = x < b1[:, lane]
        b2[:, lane] = np.where(lt, b1[:, lane],
                               np.minimum(b2[:, lane], x))
        i1[:, lane] = np.where(lt, t, i1[:, lane])
        b1[:, lane] = np.where(lt, x, b1[:, lane])
    for off in (16, 8, 4, 2, 1):
        o = np.arange(32) ^ off
        ob, oi, os_ = b1[:, o], i1[:, o], b2[:, o]
        take = (ob < b1) | ((ob == b1) & (oi < i1))
        b2 = np.where(take, np.minimum(os_, b1), np.minimum(b2, ob))
        i1 = np.where(take, oi, i1)
        b1 = np.where(take, ob, b1)
    assert (b1 == b1[:, :1]).all() and (b2 == b2[:, :1]).all()
    return i1[:, 0], b1[:, 0], b2[:, 0]


@pytest.mark.parametrize("name", list(NN))
def test_nn_lane_merge_model(name):
    # the kernel's scan and merge rule (a numpy model) against the twin's
    # best-2 (argmin, second = the row without that one entry) and its
    # columns' first best row, exactly
    c = NN[name]
    d = _hamming(c["desc_a"], c["desc_b"], c["valid_a"], c["valid_b"])
    nn, best, second = _lane_best2(d)
    rows = np.arange(d.shape[0])
    np.testing.assert_array_equal(nn, d.argmin(1))
    np.testing.assert_array_equal(best, d.min(1))
    d2 = d.astype(np.int64)
    d2[rows, d.argmin(1)] = np.iinfo(np.int32).max
    np.testing.assert_array_equal(second, d2.min(1))
    back, _, _ = _lane_best2(d.T)
    np.testing.assert_array_equal(back, d.argmin(0))
    # and the twin's outputs follow from them by the finish's rules
    ok = (best <= pmatch.TH_LOW) & (best.astype(np.float32) <= np.float32(
        c["ratio"]) * second.astype(np.float32)) & c["valid_a"]
    if c["mutual"]:
        ok &= back[nn] == rows
    if c["angles"]:
        da = c["angle_a"] - c["angle_b"][nn]
        m = np.fmod(da, np.float32(2 * np.pi)).astype(np.float32)
        m = np.where(m < 0, m + np.float32(2 * np.pi), m).astype(np.float32)
        bins = np.floor(m / np.float32(2 * np.pi) * np.float32(30)).astype(
            np.int64) % 30
        counts = np.bincount(bins[ok], minlength=30)
        thresh = max(int(np.sort(counts)[-3]), 1)
        ok &= counts[bins] >= thresh
    pm, pd = pmatch.match_nn_ratio_torch(
        *[torch.from_numpy(c[k]) for k in ("desc_a", "valid_a", "desc_b",
                                           "valid_b")],
        ratio=c["ratio"], mutual=c["mutual"],
        **({"angle_a": torch.from_numpy(c["angle_a"]),
            "angle_b": torch.from_numpy(c["angle_b"])}
           if c["angles"] else {}))
    np.testing.assert_array_equal(pm.numpy(), np.where(ok, nn, -1))
    np.testing.assert_array_equal(pd.numpy(), np.where(ok, best, BIG))


@pytest.mark.parametrize("name", list(PLACE))
def test_place_select_model(name):
    # the kernel's select (a numpy model of warp 0: lanes striding the
    # rows, max_common, the gate, the covisible maximum and the valid count
    # as reductions, the top-n as rounds of a first arg-max whose owner
    # lane rescans its rows) against the twin's packed vector
    c = PLACE[name]
    db, q, exclude, covis, kf_valid, kf, extra = \
        selfcheck.place_case_operands(c, "cpu")
    valid = (db.valid & kf_valid).numpy()
    bow, hw, qn = db.bow.numpy(), db.has_word.numpy(), q.numpy()
    score = np.minimum(bow, qn[None, :]).sum(1, dtype=np.float32)
    common = (hw & (qn > 0)[None, :]).sum(1)
    ex, cv = exclude.numpy(), covis.numpy()
    K, n = bow.shape[0], c["top_n"]
    mc = max([common[k] for k in range(K) if valid[k] and not ex[k]],
             default=0)
    thr = max(int(np.float32(c["ratio"]) * np.float32(mc)), 1)
    l1 = np.where(valid, score, 0).astype(np.float32)
    cm = np.where(valid & ~ex, common, 0)
    sc = np.where(cm >= thr, l1, 0).astype(np.float32)
    ref = max([l1[k] for k in range(K) if cv[k]], default=0.0)
    lanes = [list(range(lane, K, 32)) for lane in range(32)]

    def lane_best(lane):
        bv, bi = -1.0, None
        for k in lanes[lane]:
            if sc[k] > bv:
                bv, bi = sc[k], k
        return bv, bi

    best = [lane_best(lane) for lane in range(32)]
    ids, top = [], []
    for _ in range(n):
        v, i = max(((b, -k) for b, k in best if k is not None))
        ids.append(-i if v > 0 else -1)
        top.append(v)
        sc[-i] = -1.0
        best[-i % 32] = lane_best(-i % 32)
    _, pp = pdb.place_query_insert_torch(
        db, q, exclude, covis, kf_valid, kf, extra, c["ratio"], n)
    pp = pp.numpy()
    np.testing.assert_array_equal(pp[1:1 + n], ids)
    assert pp[1 + 2 * n] == valid.sum()
    np.testing.assert_allclose(pp[1 + n:1 + 2 * n], top, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pp[0], ref, rtol=0, atol=1e-6)
