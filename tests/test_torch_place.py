"""Port parity of loop closing, relocalisation and global BA: the Sim3
algebra, the vocabulary and BoW transform, the place database, NN-ratio
matching, Sim3 / PnP RANSAC, loop verification, the essential graph, the
map and scene-graph corrections, the LM engine and the one-device global
BA, each against the reference on the same inputs (seeded numpy, or the
shared mid-stream snapshot)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.core import plane as rplane
from visual_sgraphs_tpu.features import match as rmatch
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.optim import factors as rfactors
from visual_sgraphs_tpu.optim import solve as rsolve
from visual_sgraphs_tpu.parallel import dist_ba as rdist
from visual_sgraphs_tpu.place import database as rdb
from visual_sgraphs_tpu.place import loop_closer as rlc
from visual_sgraphs_tpu.place import pgo as rpgo
from visual_sgraphs_tpu.place import pnp as rpnp
from visual_sgraphs_tpu.place import sim3_ransac as rsim3
from visual_sgraphs_tpu.place import vocab as rvocab
from visual_sgraphs_tpu.scenegraph.state import empty_scenegraph
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.core import lie as plie
from visual_sgraphs_tpu_torch.core import plane as pplane
from visual_sgraphs_tpu_torch.features import match as pmatch
from visual_sgraphs_tpu_torch.optim import graph as pgraph
from visual_sgraphs_tpu_torch.optim import factors as pfactors
from visual_sgraphs_tpu_torch.optim import solve as psolve
from visual_sgraphs_tpu_torch.parallel import dist_ba as pdist
from visual_sgraphs_tpu_torch.place import database as pdb
from visual_sgraphs_tpu_torch.place import loop_closer as plc
from visual_sgraphs_tpu_torch.place import pgo as ppgo
from visual_sgraphs_tpu_torch.place import pnp as ppnp
from visual_sgraphs_tpu_torch.place import sim3_ransac as psim3
from visual_sgraphs_tpu_torch.place import vocab as pvocab

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

N = np.asarray


def f32(x):
    return np.asarray(x, np.float32)


def sim3_batch(rng, n=64, scale=True):
    xi = rng.normal(size=(n, 7)) * [0.5, 0.5, 0.5, 0.6, 0.6, 0.6,
                                    0.2 if scale else 0.0]
    xi[:8, 3:6] *= 1e-5  # small-angle branch
    xi[8:16, 6] *= 1e-5  # small-scale branch
    return f32(xi)


# ------------------------------------------------------------ Sim3 algebra

SIM3_OPS = {
    "exp": lambda L, xi, xj: L.sim3_exp(xi),
    "log": lambda L, xi, xj: L.sim3_log(L.sim3_exp(xi)),
    "multiply": lambda L, xi, xj: L.sim3_multiply(L.sim3_exp(xi),
                                                  L.sim3_exp(xj)),
    "inverse": lambda L, xi, xj: L.sim3_inverse(L.sim3_exp(xi)),
    "boxplus": lambda L, xi, xj: L.sim3_boxplus(L.sim3_exp(xi), xj * 0.1),
    "normalize": lambda L, xi, xj: L.sim3_normalize(L.sim3_exp(xi) * 1.01),
    "from_se3": lambda L, xi, xj: L.sim3_from_se3(L.se3_exp(xi[..., :6])),
    "to_se3": lambda L, xi, xj: L.sim3_to_se3(L.sim3_exp(xi)),
    "W_terms": lambda L, xi, xj: L._sim3_W_terms(xi[..., 3:6],
                                                 xi[..., 6:7])[0]
    + 10 * L._sim3_W_terms(xi[..., 3:6], xi[..., 6:7])[1]
    + 100 * L._sim3_W_terms(xi[..., 3:6], xi[..., 6:7])[2],
}


@pytest.mark.parametrize("op", sorted(SIM3_OPS))
def test_sim3_algebra(rng, op):
    # within 1e-6 absolute (float32 arithmetic of the same expressions)
    xi, xj = sim3_batch(rng), sim3_batch(rng)
    r = N(SIM3_OPS[op](rlie, jnp.asarray(xi), jnp.asarray(xj)))
    p = SIM3_OPS[op](plie, torch.from_numpy(xi), torch.from_numpy(xj))
    np.testing.assert_allclose(p.numpy(), r, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(r).max()))
    assert plie.sim3_identity().tolist() == N(rlie.sim3_identity()).tolist()


def test_transform_sim3(rng):
    # within 1e-5 (unit normals, metre offsets)
    S = sim3_batch(rng, 32)
    c = f32(rng.normal(size=(32, 4)))
    c[:, :3] /= np.linalg.norm(c[:, :3], axis=1, keepdims=True)
    r = rplane.transform_sim3(rlie.sim3_exp(jnp.asarray(S)), jnp.asarray(c))
    p = pplane.transform_sim3(plie.sim3_exp(torch.from_numpy(S)),
                              torch.from_numpy(c))
    np.testing.assert_allclose(p.numpy(), N(r), rtol=0, atol=1e-5)


# ---------------------------------------------------- vocabulary and BoW


@pytest.fixture(scope="module")
def vocab_case():
    snap = tp.snapshot(10)
    m = snap["map"]
    desc = N(m.kf_desc[:2]).reshape(-1, 32)[N(m.kf_kp_valid[:2]).reshape(-1)]
    rng = np.random.default_rng(3)
    extra = desc[rng.integers(0, desc.shape[0], 1200)] ^ np.packbits(
        (rng.uniform(size=(1200, 256)) < 0.05).astype(np.uint8), axis=1)
    train = np.concatenate([desc, extra])
    return snap, train, rvocab.fit_vocab(train, 8, 3, seed=0)


def test_fit_vocab_same_tree(vocab_case):
    # exact: the same numpy training loop and seed
    _, train, ref = vocab_case
    port = pvocab.fit_vocab(train, 8, 3, seed=0)
    assert len(port.centers) == len(ref.centers) == 3
    for a, b in zip(port.centers, ref.centers):
        np.testing.assert_array_equal(a.numpy(), N(b))
    np.testing.assert_array_equal(port.idf.numpy(), N(ref.idf))


def test_descend_and_bow_vectors(vocab_case):
    # words exact; BoW rows within 1e-6 (summation order)
    snap, _, ref = vocab_case
    m = snap["map"]
    tree = interop.vocab_from_numpy(interop_vocab_np(ref))
    desc, valid = N(m.kf_desc), N(m.kf_kp_valid)
    words = pvocab.descend(tree, torch.from_numpy(desc.reshape(-1, 32)))
    np.testing.assert_array_equal(
        words.numpy(), N(rvocab.descend(ref, jnp.asarray(desc.reshape(-1,
                                                                      32)))))
    bows = pvocab.bow_vectors(tree, torch.from_numpy(desc),
                              torch.from_numpy(valid))
    rb = N(rlc._backfill_bow(ref, jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_allclose(bows.numpy(), rb, rtol=0, atol=1e-6)
    one = pvocab.bow_vector(tree, torch.from_numpy(desc[1]),
                            torch.from_numpy(valid[1]))
    np.testing.assert_allclose(one.numpy(), rb[1], rtol=0, atol=1e-6)


def interop_vocab_np(tree) -> dict:
    return {"centers": [N(c) for c in tree.centers], "idf": N(tree.idf)}


def test_vocab_and_db_round_trip(vocab_case, tmp_path):
    # exact: a tree saved by the reference loads into the port, and both
    # round-trip through numpy
    _, _, ref = vocab_case
    path = str(tmp_path / "vocab.npz")
    rvocab.save_vocab(ref, path)
    tree = pvocab.load_vocab(path)
    back = interop.vocab_to_numpy(tree)
    for a, b in zip(back["centers"], ref.centers):
        np.testing.assert_array_equal(a, N(b))
    np.testing.assert_array_equal(back["idf"], N(ref.idf))
    db = rdb.build_db(jnp.ones((4, 8), jnp.float32) * 0.1,
                      jnp.asarray([True, False, True, True]))
    pdb_ = interop.placedb_from_numpy(tp.to_np(db))
    for k, v in interop.placedb_to_numpy(pdb_).items():
        np.testing.assert_array_equal(v, N(getattr(db, k)))


# ------------------------------------------------------------- database


def db_case(rng, K=24, W=64):
    bows = rng.uniform(size=(K, W)) * (rng.uniform(size=(K, W)) < 0.3)
    bows = f32(bows / np.maximum(bows.sum(1, keepdims=True), 1e-12))
    valid = rng.uniform(size=K) > 0.2
    q = bows[5] * f32(rng.uniform(0.5, 1.5, W))
    q = f32(q / q.sum())
    exclude = rng.uniform(size=K) < 0.25
    covis = rng.uniform(size=K) < 0.3
    return bows, valid, q, exclude, covis


@pytest.mark.parametrize("ratio", [0.8, 0.5])
def test_database_query(rng, ratio):
    # candidate ids and valid count exact, scores within 1e-6
    bows, valid, q, exclude, covis = db_case(rng)
    rd = rdb.build_db(jnp.asarray(bows), jnp.asarray(valid))
    pd = pdb.build_db(torch.from_numpy(bows), torch.from_numpy(valid))
    for k in ("bow", "has_word", "valid"):
        np.testing.assert_array_equal(getattr(pd, k).numpy(),
                                      N(getattr(rd, k)))
    np.testing.assert_allclose(
        pdb.l1_scores(pd, torch.from_numpy(q)).numpy(),
        N(rdb.l1_scores(rd, jnp.asarray(q))), rtol=0, atol=1e-6)
    rids, rsc = rdb.detect_candidates(rd, jnp.asarray(q), jnp.asarray(
        exclude), min_common_ratio=ratio, top_n=3)
    rref = rdb.best_covisible_score(rd, jnp.asarray(q), jnp.asarray(covis))
    packed = pdb.place_query(pd, torch.from_numpy(q),
                             torch.from_numpy(exclude),
                             torch.from_numpy(covis), ratio, 3).numpy()
    np.testing.assert_array_equal(packed[1:4], N(rids))
    np.testing.assert_allclose(packed[4:7], N(rsc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(packed[0], float(rref), rtol=0, atol=1e-6)
    assert packed[7] == valid.sum()
    # insertion
    rn = rdb.add_keyframe(rd, jnp.asarray(3, jnp.int32), jnp.asarray(q))
    pn = pdb.add_keyframe(pd, 3, torch.from_numpy(q))
    for k in ("bow", "has_word", "valid"):
        np.testing.assert_array_equal(getattr(pn, k).numpy(),
                                      N(getattr(rn, k)))


# ---------------------------------------------------- NN-ratio matching


@pytest.mark.parametrize("angles", [True, False])
def test_match_nn_ratio(angles):
    # exact: integer Hamming distances, first-index ties, same histogram
    m = tp.snapshot(10)["map"]
    obs = N(m.kf_obs_pt)
    va = N(m.kf_kp_valid[0]) & (obs[0] >= 0)
    vb = N(m.kf_kp_valid[1]) & (obs[1] >= 0)
    kw = dict(ratio=0.85)
    if angles:
        kw.update(angle_a=N(m.kf_angle[0]), angle_b=N(m.kf_angle[1]))
    r = rmatch.match_nn_ratio(m.kf_desc[0], jnp.asarray(va), m.kf_desc[1],
                              jnp.asarray(vb),
                              **{k: jnp.asarray(v) if k.startswith("angle")
                                 else v for k, v in kw.items()})
    p = pmatch.match_nn_ratio(
        torch.from_numpy(N(m.kf_desc[0])), torch.from_numpy(va),
        torch.from_numpy(N(m.kf_desc[1])), torch.from_numpy(vb),
        **{k: torch.from_numpy(v) if k.startswith("angle") else v
           for k, v in kw.items()})
    np.testing.assert_array_equal(p[0].numpy(), N(r[0]))
    np.testing.assert_array_equal(p[1].numpy(), N(r[1]))
    assert (N(r[0]) >= 0).sum() > 50


def test_guided_count_matches_dense_rule(rng):
    # exact: the any-per-row count of the reference's dense expression
    n = 300
    uv_b = f32(rng.uniform((0, 0), (320, 240), (n, 2)))
    uv_a = uv_b + f32(rng.normal(size=(n, 2)) * 6)
    da = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    db_ = da ^ np.packbits((rng.uniform(size=(n, 256)) < 0.2).astype(
        np.uint8), axis=1)
    va, vb = rng.uniform(size=n) > 0.1, rng.uniform(size=n) > 0.1
    d2 = jnp.sum((jnp.asarray(uv_a)[:, None] - jnp.asarray(uv_b)[None]) ** 2,
                 axis=-1)
    hd = rmatch.hamming_matrix(jnp.asarray(da), jnp.asarray(db_))
    want = int(jnp.sum(jnp.any((d2 < 64.0) & jnp.asarray(va)[:, None]
                               & jnp.asarray(vb)[None] & (hd <= 64), axis=1)))
    got = pmatch.guided_count_torch(*(torch.from_numpy(x) for x in (
        uv_a, va, da, uv_b, vb, db_)))
    assert int(got) == want > 20


# ------------------------------------------------------ Sim3 RANSAC


def reference_choice(key: int, valid, n_hyp=256):
    w = jnp.asarray(N(valid)).astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    return N(jax.random.choice(jax.random.PRNGKey(key), w.shape[0],
                               shape=(n_hyp, 3), replace=True, p=probs))


def reference_picks(key: int, valid, n_hyp=192):
    logits = jnp.where(jnp.asarray(N(valid)), 0.0, -1e9)
    return N(jax.random.categorical(jax.random.PRNGKey(key),
                                    logits[None, None, :], axis=-1,
                                    shape=(n_hyp, 6)))


def sim3_points(rng, n=400):
    p_a = f32(np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        rng.uniform(1, 6, n)], -1))
    S = rlie.sim3_exp(jnp.asarray(f32([0.2, -0.1, 0.3, 0.05, -0.2, 0.1,
                                       0.0])))
    p_b = N(rlie.sim3_apply(S, jnp.asarray(p_a)))
    p_b = f32(p_b + rng.normal(size=p_b.shape) * 0.01)
    out = rng.uniform(size=n) < 0.3
    p_b[out] += f32(rng.uniform(-1, 1, (int(out.sum()), 3)))
    return p_a, p_b, rng.uniform(size=n) > 0.1


def test_inverse_cdf_samples_follow_choice_rule(rng):
    # exact: the same uniforms through jax.random.choice's rule
    valid = rng.uniform(size=50) > 0.5
    u = f32(rng.uniform(size=(64, 3)))
    p_cuml = np.cumsum(valid.astype(np.float32))
    want = np.searchsorted(p_cuml, p_cuml[-1] * (1 - u))
    got = plc.inverse_cdf_samples(torch.from_numpy(valid),
                                  torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert valid[got.numpy()].all()


@pytest.mark.parametrize("fix_scale", [True, False])
def test_ransac_and_refine_sim3(rng, fix_scale):
    # on the reference's samples: S within 1e-4, inlier counts exact
    p_a, p_b, valid = sim3_points(rng)
    key = 17
    r = rsim3.ransac_sim3(jnp.asarray(p_a), jnp.asarray(p_b),
                          jnp.asarray(valid), jax.random.PRNGKey(key),
                          inlier_thresh=0.12, fix_scale=fix_scale)
    samples = torch.from_numpy(reference_choice(key, valid))
    args = (torch.from_numpy(p_a), torch.from_numpy(p_b),
            torch.from_numpy(valid))
    p = psim3.ransac_sim3_torch(*args, samples, 0.12, fix_scale)
    np.testing.assert_allclose(p.S_ab.numpy(), N(r.S_ab), rtol=0, atol=1e-4)
    assert int(p.n_inliers) == int(r.n_inliers)
    rr = rsim3.refine_sim3(r.S_ab, jnp.asarray(p_a), jnp.asarray(p_b),
                           jnp.asarray(valid), inlier_thresh=0.12,
                           fix_scale=fix_scale)
    pr = psim3.verify_sim3(*args, samples, 0.12, fix_scale)
    np.testing.assert_allclose(pr.S_ab.numpy(), N(rr.S_ab), rtol=0,
                               atol=1e-4)
    assert int(pr.n_inliers) == int(rr.n_inliers) > 200


def test_refine_jacobian_is_jacfwd_of_boxplus(rng):
    # the analytic [I, -[y]x, y] equals forward AD through sim3_boxplus at
    # zero (float64, 1e-12)
    p_a, _, _ = sim3_points(rng, 20)
    S = plie.sim3_normalize(plie.sim3_exp(torch.tensor(
        f32([0.1, 0.2, -0.3, 0.2, -0.1, 0.3, 0.1]))).double())
    pa = torch.from_numpy(p_a).double()
    J = torch.func.jacfwd(lambda xi: plie.sim3_apply(
        plie.sim3_boxplus(S, xi), pa))(torch.zeros(7, dtype=torch.float64))
    np.testing.assert_allclose(psim3.sim3_point_jacobian(S, pa).numpy(),
                               J.numpy(), rtol=0, atol=1e-12)


# ------------------------------------------------------ loop verification


def test_loop_geometry_on_snapshot():
    # counts exact, S within 1e-4 (keyframes 1 -> 0 of the snapshot)
    snap = tp.snapshot(10)
    m, cfg = snap["map"], snap["cfg"]
    K = jnp.asarray(cfg.camera.K)
    key = 5
    r = rlc._loop_geometry(m, jnp.asarray(1, jnp.int32),
                           jnp.asarray(0, jnp.int32), jax.random.PRNGKey(key),
                           0.12, K, fix_scale=True)
    pm = tp.port_map(m)
    p = plc._loop_geometry(pm, 1, 0, lambda v: torch.from_numpy(
        reference_choice(key, v.numpy())).to(torch.int32), 0.12, tp.t(K),
        fix_scale=True)
    np.testing.assert_allclose(p[0].numpy(), N(r[0]), rtol=0, atol=1e-4)
    assert [int(x) for x in p[1:]] == [int(x) for x in r[1:]]
    assert int(r[1]) > 30 and int(r[2]) > 30
    drift_r = float(rlc._loop_drift(m.kf_pose, 1, 0, r[0]))
    drift_p = float(plc._loop_drift(pm.kf_pose, 1, 0, p[0]))
    assert abs(drift_r - drift_p) < 1e-4


# ------------------------------------------------------------------- PnP


def pnp_case(rng, n=400):
    K = f32([260.0, 260.0, 159.5, 119.5])
    T = rlie.se3_exp(jnp.asarray(f32([0.2, -0.1, 0.3, 0.05, -0.1, 0.02])))
    p_cam = f32(np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                          rng.uniform(1.5, 6, n)], -1))
    xw = f32(N(rlie.se3_apply(rlie.se3_inverse(T), jnp.asarray(p_cam))))
    uv = f32(np.stack([K[0] * p_cam[:, 0] / p_cam[:, 2] + K[2],
                       K[1] * p_cam[:, 1] / p_cam[:, 2] + K[3]], -1))
    uv = f32(uv + rng.normal(size=uv.shape) * 0.5)
    out = rng.uniform(size=n) < 0.3
    uv[out] = f32(rng.uniform((0, 0), (320, 240), (int(out.sum()), 2)))
    return xw, uv, rng.uniform(size=n) > 0.1, K


def test_ransac_pnp_on_reference_picks(rng):
    # on the reference's picks: pose within 1e-4, inliers exact
    xw, uv, valid, K = pnp_case(rng)
    key = 3
    r = rpnp.ransac_pnp(jnp.asarray(xw), jnp.asarray(uv), jnp.asarray(valid),
                        jnp.asarray(K), jax.random.PRNGKey(key), n_hyp=192)
    picks = torch.from_numpy(reference_picks(key, valid)).to(torch.int32)
    p = ppnp.ransac_pnp(torch.from_numpy(xw), torch.from_numpy(uv),
                        torch.from_numpy(valid), torch.from_numpy(K), picks)
    np.testing.assert_allclose(p.T_cw.numpy(), N(r.T_cw), rtol=0, atol=1e-4)
    assert int(p.n_inliers) == int(r.n_inliers) > 200


def test_dlt_pose_matches_reference(rng):
    # per hypothesis, float64 (the float32 12x12 eigenvector is
    # conditioning-limited in both packages): within 1e-8
    xw, uv, valid, K = pnp_case(rng)
    xy = f32(np.stack([(uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]],
                      1))
    picks = reference_picks(4, valid, 32)
    # six distinct matches (a repeated pick leaves a null space of more
    # than one dimension, whose eigenvector either package may return)
    picks = picks[[len(set(p)) == 6 for p in picks]][:16]
    r = jax.vmap(rpnp._dlt_pose)(jnp.asarray(xw[picks], jnp.float64),
                                 jnp.asarray(xy[picks], jnp.float64))
    p = ppnp._dlt_pose(torch.from_numpy(xw[picks]).double(),
                       torch.from_numpy(xy[picks]).double())
    np.testing.assert_allclose(p.numpy(), N(r), rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def reloc_case():
    snap = tp.snapshot(10)
    m = snap["map"]
    desc = N(m.kf_desc[:2]).reshape(-1, 32)[N(m.kf_kp_valid[:2]).reshape(-1)]
    ref_tree = rvocab.fit_vocab(desc, 8, 2, seed=0)
    bows = rlc._backfill_bow(ref_tree, m.kf_desc, m.kf_kp_valid)
    return snap, ref_tree, rdb.build_db(bows, m.kf_valid)


def test_reloc_in_map_on_snapshot(reloc_case):
    # the frame after the snapshot: the same candidate, pose within 1e-4
    snap, ref_tree, ref_db = reloc_case
    m, cfg = snap["map"], snap["cfg"]
    r = rlc.reloc_in_map(m, ref_db, ref_tree, snap["frame"],
                         jnp.asarray(cfg.camera.K), 30)
    tree = interop.vocab_from_numpy(interop_vocab_np(ref_tree))
    db = interop.placedb_from_numpy(tp.to_np(ref_db))
    p = plc.reloc_in_map(
        tp.port_map(m), db, tree, tp.port_frame(snap["frame"]),
        tp.t(cfg.camera.K), 30,
        draw=lambda kind, key, v: torch.from_numpy(
            reference_picks(key, v.numpy())).to(torch.int32))
    assert r is not None and p is not None
    assert p[1] == r[1]
    np.testing.assert_allclose(p[0].numpy(), N(r[0]), rtol=0, atol=1e-4)


# ------------------------------------------------------- essential graph


@pytest.fixture(scope="module")
def graph_case():
    snap = tp.snapshot(10)
    m = snap["map"]
    # a third keyframe: keyframe 1's observations under a perturbed pose,
    # so the graph has a consecutive chain and covisibility edges
    T2 = rlie.se3_boxplus(m.kf_pose[1], jnp.asarray(
        f32([0.05, -0.02, 0.08, 0.01, 0.02, -0.01])))
    copied = {f: getattr(m, f).at[2].set(getattr(m, f)[1]) for f in (
        "kf_obs_pt", "kf_kp_valid", "kf_uv", "kf_depth", "kf_desc",
        "kf_angle", "kf_level")}
    m3 = m._replace(
        kf_pose=m.kf_pose.at[2].set(T2), kf_valid=m.kf_valid.at[2].set(True),
        kf_seq=m.kf_seq.at[2].set(2), n_kf=jnp.asarray(3, jnp.int32),
        **copied)
    return snap, m3


def test_build_covis_edges(graph_case):
    # the same edge set (ids and validity exact)
    _, m = graph_case
    r = rpgo.build_covis_edges(m, min_weight=30, max_edges=16)
    p = ppgo.build_covis_edges(tp.port_map(m), min_weight=30, max_edges=16)
    np.testing.assert_array_equal(p.idx.numpy(), N(r.idx))
    np.testing.assert_array_equal(p.valid.numpy(), N(r.valid))
    assert int(N(r.valid).sum()) >= 3


def _loop_constraint(m):
    S = rlie.sim3_multiply(rlie.sim3_from_se3(m.kf_pose[0]),
                           rlie.sim3_inverse(rlie.sim3_from_se3(
                               m.kf_pose[2])))
    return rlie.sim3_boxplus(S, jnp.asarray(f32([0.03, -0.02, 0.04, 0.01,
                                                 -0.02, 0.01, 0.0])))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_essential_graph(graph_case, fix_scale):
    # poses within 1e-4 of the reference's float64 solve; H of the
    # generic linearisation (K19's twin) within 1e-4 relative of it
    _, m = graph_case
    edges = rpgo.build_covis_edges(m, min_weight=30, max_edges=16)
    S_loop = _loop_constraint(m)
    fixed = jnp.zeros((m.K,), bool).at[0].set(True)
    r = rpgo.optimize_essential_graph(
        m.kf_pose.astype(jnp.float64), m.kf_valid, edges, 0, 2,
        S_loop.astype(jnp.float64), fixed, iters=20, fix_scale=fix_scale)
    pe = ppgo.EssentialEdges(tp.t(edges.idx), tp.t(edges.valid))
    p = ppgo.optimize_essential_graph(
        tp.t(m.kf_pose), tp.t(m.kf_valid), pe, 0, 2, tp.t(S_loop),
        tp.t(fixed), iters=20, fix_scale=fix_scale)
    np.testing.assert_allclose(p.kf_pose.numpy(), N(r.kf_pose), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p.S_new.numpy(), N(r.S_new), rtol=0,
                               atol=1e-4)
    assert float(p.cost) < float(p.cost0)


def test_pgo_assemble_matches_reference_linearisation(graph_case):
    # K19's plain twin against the reference's _assemble of the same
    # problem, float64: within 1e-10 relative
    _, m = graph_case
    edges = rpgo.build_covis_edges(m, min_weight=30, max_edges=16)
    S_loop = _loop_constraint(m)
    pe = ppgo.EssentialEdges(tp.t(edges.idx), tp.t(edges.valid))
    S_old, var_idx, S_meas, info, valid = ppgo.essential_graph(
        tp.t(m.kf_pose).double(), tp.t(m.kf_valid), pe, 0, 2,
        tp.t(S_loop).double())
    H, g = ppgo.pgo_assemble(S_old, var_idx, S_meas, info, valid, True)
    batch = rgraph.FactorBatch(
        families=("kf", "kf"), residual_fn=rfactors.relative_sim3, res_dim=7,
        var_idx=jnp.asarray(var_idx.numpy()),
        const={"S_ji": jnp.asarray(S_meas.numpy())},
        info=jnp.asarray(info.numpy()), valid=jnp.asarray(valid.numpy()))
    fam = rgraph.sim3_family(jnp.asarray(S_old.numpy()))
    fam = dataclasses.replace(fam, retract=lambda v, d: rlie.sim3_boxplus(
        v, d.at[..., 6].set(0.0)))
    prob = rgraph.GraphProblem(families={"kf": fam}, factors=[batch])
    rH, rg, _, _, _ = rsolve._assemble(prob, {"kf": jnp.asarray(
        S_old.numpy())})
    np.testing.assert_allclose(H.numpy(), N(rH), rtol=0,
                               atol=1e-10 * np.abs(N(rH)).max())
    np.testing.assert_allclose(g.numpy(), N(rg), rtol=0,
                               atol=1e-10 * np.abs(N(rg)).max())
    c = ppgo.pgo_cost(S_old, var_idx, S_meas, info, valid)
    np.testing.assert_allclose(float(c), float(rsolve.problem_cost(
        prob, {"kf": jnp.asarray(S_old.numpy())})), rtol=1e-10)


def test_correct_map_and_scenegraph(graph_case, rng):
    # within 1e-5
    _, m = graph_case
    edges = rpgo.build_covis_edges(m, min_weight=30, max_edges=16)
    fixed = jnp.zeros((m.K,), bool).at[0].set(True)
    res = rpgo.optimize_essential_graph(m.kf_pose, m.kf_valid, edges, 0, 2,
                                        _loop_constraint(m), fixed, iters=5)
    r = rpgo.correct_map(m, res)
    pres = ppgo.PgoResult(*(tp.t(x) for x in res))
    p = ppgo.correct_map(tp.port_map(m), pres)
    np.testing.assert_allclose(p.pt_pos.numpy(), N(r.pt_pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p.kf_pose.numpy(), N(r.kf_pose), rtol=0,
                               atol=1e-5)
    from visual_sgraphs_tpu.config import CapacityConfig
    sg = empty_scenegraph(CapacityConfig(max_planes=8, max_rooms=4,
                                         max_doors=4, max_markers=4),
                          max_obs=16)
    c = f32(rng.normal(size=(8, 4)))
    c[:, :3] /= np.linalg.norm(c[:, :3], axis=1, keepdims=True)
    door = f32(np.c_[np.ones(4), np.zeros((4, 3)),
                     rng.normal(size=(4, 3))])
    sg = sg._replace(
        pl_coeffs=jnp.asarray(c), pl_valid=jnp.arange(8) < 5,
        pl_centroid=jnp.asarray(f32(rng.normal(size=(8, 3)))),
        ob_kf=jnp.asarray(np.r_[[0, 1, 2, 1, 2, 0], np.zeros(10)]
                          .astype(np.int32)),
        ob_plane=jnp.asarray(np.r_[[0, 1, 2, 3, 4, 4], -np.ones(10)]
                             .astype(np.int32)),
        ob_valid=jnp.arange(16) < 6,
        room_walls=jnp.asarray(np.r_[[[1, 2, -1, -1]], -np.ones((3, 4))]
                               .astype(np.int32)),
        room_valid=jnp.arange(4) < 1,
        room_center=jnp.asarray(f32(rng.normal(size=(4, 3)))),
        door_pose=jnp.asarray(door), door_valid=jnp.arange(4) < 2,
        marker_pose=jnp.asarray(f32(np.r_[door, door])),
        marker_valid=jnp.arange(8) < 3)
    r_sg = rpgo.correct_scenegraph(sg, res, r)
    p_sg = ppgo.correct_scenegraph(
        interop.scenegraph_from_numpy(tp.to_np(sg)), pres, p)
    for k in ("pl_coeffs", "pl_centroid", "room_center", "door_pose",
              "marker_pose"):
        np.testing.assert_allclose(getattr(p_sg, k).numpy(),
                                   N(getattr(r_sg, k)), rtol=0, atol=1e-5,
                                   err_msg=k)


# ------------------------------------------------------------ LM engine


def small_problem(pkg, eliminate):
    """Two SE3 poses and six points, float64: reprojection factors, pose 0
    fixed; the points eliminated or kept in the dense system.  (The
    depth / baseline scale is weakly observed here, so two float32 solves
    summed in other orders part by ~1e-3: the engines are compared in
    float64.)"""
    rng = np.random.default_rng(11)
    X = f32(np.stack([rng.uniform(-1, 1, 6), rng.uniform(-1, 1, 6),
                      rng.uniform(3, 5, 6)], -1))
    T = f32(np.stack([[1, 0, 0, 0, 0, 0, 0], [1, 0, 0, 0, -0.3, 0.05, 0.1]]))
    cam = f32([260.0, 260.0, 160.0, 120.0])
    uv = []
    for k in range(2):
        p = X + T[k, 4:]
        uv.append(np.c_[cam[0] * p[:, 0] / p[:, 2] + cam[2],
                        cam[1] * p[:, 1] / p[:, 2] + cam[3]])
    uv = f32(np.concatenate(uv) + rng.normal(size=(12, 2)) * 0.5)
    vi = np.c_[np.repeat([0, 1], 6), np.tile(np.arange(6), 2)].astype(
        np.int32)
    X0 = f32(X + rng.normal(size=X.shape) * 0.05)
    T0 = T.copy()
    T0[1, 4:] += 0.03
    if pkg == "ref":
        G, F = rgraph, rfactors

        def a(x):
            return jnp.asarray(x.astype(np.float64) if x.dtype == np.float32
                               else x)
    else:
        G, F = pgraph, pfactors

        def a(x):
            return torch.from_numpy(x.astype(np.float64)
                                    if x.dtype == np.float32 else x)
    fixed = a(np.array([True, False]))
    fams = {"kf": G.se3_family(a(T0), fixed), "pt": G.point_family(a(X0))}
    batch = G.FactorBatch(("kf", "pt"), F.reproj_mono if pkg == "ref"
                          else _port_reproj, 2, a(vi),
                          {"uv": a(uv), "cam": a(np.tile(cam, (12, 1)))},
                          a(np.ones(12, np.float32)), a(np.ones(12, bool)),
                          huber=2.0)
    return G.GraphProblem(families=fams, factors=[batch],
                          eliminated="pt" if eliminate else None)


def _port_reproj(values, const):
    from visual_sgraphs_tpu_torch.core import cameras
    T_cw, X_w = values
    return cameras.project_pinhole(const["cam"],
                                   plie.se3_apply(T_cw, X_w)) - const["uv"]


@pytest.mark.parametrize("eliminate", [True, False])
def test_optimize_with_and_without_elimination(eliminate):
    # float64, 8 iterations: values within 1e-8, accept history equal
    r = rsolve.optimize(small_problem("ref", eliminate), iters=8)
    p = psolve.optimize(small_problem("port", eliminate), iters=8)
    for k in ("kf", "pt"):
        np.testing.assert_allclose(p.values[k].numpy(), N(r.values[k]),
                                   rtol=0, atol=1e-8)
    np.testing.assert_array_equal(p.accepted.numpy(), N(r.accepted))
    np.testing.assert_allclose(float(p.cost), float(r.cost), rtol=1e-8)
    assert float(p.cost) < float(p.initial_cost)


# -------------------------------------------------------- global BA


@pytest.mark.parametrize("port_dtype", ["float32", "float64"])
def test_global_ba_one_device(graph_case, port_dtype):
    # poses within 1e-4, points within 1e-3 of the reference's float64
    # solve (the rule of test_torch_mapping.py)
    snap, m = graph_case
    cfg = snap["cfg"]
    fields = ("kf_pose", "pt_pos", "kf_uv", "kf_depth")
    r64 = m._replace(**{f: getattr(m, f).astype(jnp.float64)
                        for f in fields})
    r, r_costs = rdist.global_ba_sharded(
        r64, jnp.asarray(cfg.camera.K, jnp.float64),
        jnp.asarray(np.float32(cfg.camera.bf), jnp.float64),
        rdist.make_mesh(1), iters=10)
    dt = getattr(torch, port_dtype)
    pm = tp.port_map(m)
    pm = pm._replace(**{f: getattr(pm, f).to(dt) for f in fields})
    p, p_costs = pdist.global_ba_sharded(
        pm, tp.t(cfg.camera.K).to(dt),
        torch.tensor(np.float32(cfg.camera.bf), dtype=dt), iters=10)
    np.testing.assert_allclose(p.kf_pose.numpy(), N(r.kf_pose), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p.pt_pos.numpy(), N(r.pt_pos), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(p_costs.numpy(), N(r_costs), rtol=1e-3)
    assert np.abs(N(r.kf_pose) - N(m.kf_pose)).max() > 1e-6
