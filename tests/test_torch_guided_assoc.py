"""K16 (loop verification's guided re-match count under the refined Sim3)
and K24 (plane association) on the CPU, on the seeded cases that
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` run through the kernels
on the card (``selfcheck.guided_cases`` / ``assoc_cases``):

- ``guided_count_sim3_torch`` (the kernel's twin: the rows' validity, the
  Sim3, the projection, the in-front gate and the count) against the
  reference's expressions (``place/loop_closer.py:86-100``), exactly:
  points behind the camera or at z = 0.04 whose images land on keypoints,
  no valid keypoint, pairs at exactly 64 and 65 bits, one keypoint, a
  scaled Sim3 with n_a != n_b, and the 1000 x 1000 seeded shape;
- a numpy model of the kernel's walk (a warp a row, the lanes over the
  keypoints 32 at a time, a row ending at its first chunk with a hit, CTA
  partials summed by the last CTA) against the twin;
- a numpy model of K24's order (the whole detection x plane score table
  from the staged planes, then the detections in order with only the
  planes an earlier one changed recomputed, the blend from the stored
  chart distance, the voxel keys a key at a time over the detections)
  against ``associate_and_update_torch``: integer fields exact, floats
  within 1e-5 (two detections of one plane, a detection matching a plane
  an earlier one created, P full, Q full, an invalid detection, an
  arg-min tie, voxel keys of -1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import cameras as rcams
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.features import match as pmatch
from visual_sgraphs_tpu_torch.scenegraph import manager as pman

from torch_parity import one_torch_thread  # noqa: F401

GUIDED_CASES = {c["name"]: c for c in selfcheck.guided_cases()}
GUIDED_CASES["seeded"] = selfcheck.guided_case(np.random.default_rng(0),
                                               "seeded")
ASSOC_CASES = {c["name"]: c for c in selfcheck.assoc_cases()}
WARPS = 8  # the kernel's rows a CTA


def reference_guided(c: dict) -> int:
    """``_loop_geometry``'s guided count (reference, :86-100) on the case's
    operands."""
    S, p_a, cam = (jnp.asarray(c[k]) for k in ("S", "p_a", "cam"))
    obs_a = jnp.asarray(c["obs_a"])
    pt_a = jnp.maximum(obs_a, 0)
    va_all = (jnp.asarray(c["kp_valid_a"]) & (obs_a >= 0)
              & jnp.asarray(c["pt_valid"])[pt_a])
    p_a_cam = rlie.sim3_apply(S, p_a)
    uv_proj = rcams.project_pinhole(cam, p_a_cam)
    in_front = p_a_cam[:, 2] > 0.05
    uv_b = jnp.asarray(c["uv_b"])
    d2 = jnp.sum((uv_proj[:, None, :] - uv_b[None, :, :]) ** 2, axis=-1)
    near = ((d2 < 8.0 ** 2) & (va_all & in_front)[:, None]
            & jnp.asarray(c["kp_valid_b"])[None, :])
    xor = jnp.bitwise_xor(jnp.asarray(c["desc_a"])[:, None, :],
                          jnp.asarray(c["desc_b"])[None, :, :])
    hd = jnp.sum(jax.lax.population_count(xor).astype(jnp.int32), axis=-1)
    return int(jnp.sum(jnp.any(near & (hd <= 64), axis=1).astype(jnp.int32)))


def twin_guided(c: dict) -> torch.Tensor:
    return pmatch.guided_count_sim3_torch(*selfcheck.guided_operands(c,
                                                                     "cpu"))


@pytest.mark.parametrize("name", list(GUIDED_CASES))
def test_guided_twin_matches_reference(name):
    c = GUIDED_CASES[name]
    got = twin_guided(c)
    assert got.dtype == torch.int32 and got.shape == ()
    want = reference_guided(c)
    assert int(got) == want
    # each case reaches its hazard
    if name in ("no_valid_b",):
        assert want == 0
    elif name == "one_b":
        assert want == 1
    else:
        assert want > 10


def test_guided_gates_decide():
    # the in-front gate and the 64-bit bound each remove rows that would
    # otherwise count: without them the reference's count grows
    c = GUIDED_CASES["behind"]
    rows, near = selfcheck._guided_pairs(selfcheck.guided_operands(c, "cpu"))
    S = c["S"].astype(np.float64)
    z = selfcheck._sim3_np(S, c["p_a"].astype(np.float64))[:, 2]
    assert (z < 0).sum() >= 40 and ((z > 0) & (z < 0.05)).sum() >= 10
    assert not rows[torch.from_numpy(z <= 0.05)].any()
    h = GUIDED_CASES["hamming_64"]
    bits = np.unpackbits(h["desc_a"][h["src"]] ^ h["desc_b"][:len(h["src"])],
                         axis=1).sum(1)
    assert set(bits.tolist()) == {64, 65}


def kernel_walk(c: dict) -> int:
    """The kernel's count step by step: a warp a row of ``a`` (WARPS rows a
    CTA), the 32 lanes over ``b`` a chunk at a time, the row ending at the
    first chunk in which a lane hits; each CTA's rows summed, the CTA sums
    added by the last CTA."""
    args = selfcheck.guided_operands(c, "cpu")
    rows, near = selfcheck._guided_pairs(args)
    hd = pmatch.hamming_matrix(args[5], args[8]).numpy()
    near, rows = near.numpy(), rows.numpy()
    n_a, n_b = near.shape
    partials = []
    for cta in range(max(1, -(-n_a // WARPS))):
        hits = 0
        for a in range(cta * WARPS, min(n_a, (cta + 1) * WARPS)):
            if not rows[a]:
                continue
            for b0 in range(0, n_b, 32):
                lanes = range(b0, min(n_b, b0 + 32))
                if any(near[a, b] and hd[a, b] <= 64 for b in lanes):
                    hits += 1
                    break
        partials.append(hits)
    return sum(partials)


@pytest.mark.parametrize("name", list(GUIDED_CASES))
def test_guided_kernel_walk_model(name):
    c = GUIDED_CASES[name]
    assert kernel_walk(c) == int(twin_guided(c))


# ------------------------------------------------------------------ K24


def normal_rotation(v):
    az = np.arctan2(v[1], v[0])
    el = np.arctan2(v[2], np.hypot(v[0], v[1]))
    ca, sa, ce, se = np.cos(az), np.sin(az), np.cos(el), np.sin(el)
    return np.array([[ca * ce, -sa, -ca * se], [sa * ce, ca, -sa * se],
                     [se, 0.0, ce]])


def ominus(R, ref, other):
    n = R.T @ other[:3]
    return np.array([np.arctan2(n[1], n[0]),
                     np.arctan2(n[2], np.hypot(n[0], n[1])),
                     -other[3] + ref[3]])


def oplus(R, coeffs, delta):
    c, s = np.cos(delta[1]), np.sin(delta[1])
    v = R @ np.array([c * np.cos(delta[0]), c * np.sin(delta[0]), s])
    out = np.concatenate([v, [coeffs[3] - delta[2]]])
    return out / max(np.linalg.norm(v), np.finfo(np.float32).tiny)


def assoc_model(case: dict, ominus_thresh=0.3, dist_thresh=0.35,
                centroid_thresh=1.5) -> dict:
    """K24's order in float64: the score table of every detection against
    the staged planes at once, then the detections in order, recomputing
    only the planes an earlier detection matched or created."""
    d = {k: np.array(v, np.float64 if v.dtype == np.float32 else v.dtype)
         for k, v in case["sg"].items()}
    det = {k: np.asarray(v, np.float64) if v.dtype == np.float32 else v
           for k, v in case["det"].items()}
    P, V = d["pl_vox"].shape
    Q = d["ob_kf"].shape[0]
    n_det = det["coeffs"].shape[0]

    def score(p, i):
        R = normal_rotation(d["pl_coeffs"][p][:3])
        om = ominus(R, d["pl_coeffs"][p], det["coeffs"][i])
        ang, dd = np.hypot(om[0], om[1]), abs(om[2])
        cdist = np.linalg.norm(d["pl_centroid"][p] - det["centroid"][i])
        cand = (d["pl_valid"][p] and ang < ominus_thresh
                and dd < dist_thresh and cdist < centroid_thresh)
        return (ang + dd if cand else np.inf), om, R

    table = [[score(p, i) for p in range(P)] for i in range(n_det)]
    dirty = np.zeros(P, bool)
    pids = []
    for i in range(n_det):
        row = list(table[i])
        for p in range(P):
            fresh = score(p, i)
            if dirty[p]:
                row[p] = fresh
            else:  # what the order relies on: a clean plane's score holds
                assert fresh[0] == row[p][0]
        scores = np.array([r[0] for r in row])
        b = int(np.argmin(scores))
        ok = bool(det["valid"][i])
        matched = ok and np.isfinite(scores[b])
        npts = det["npts"][i]
        if matched:
            w_old = max(d["pl_npts"][b], 1.0)
            w_new = max(npts, 1.0)
            alpha = w_new / (w_old + w_new)
            _, om, R = row[b]
            d["pl_coeffs"][b] = oplus(R, d["pl_coeffs"][b], alpha * om)
            d["pl_centroid"][b] = (d["pl_centroid"][b] * (1 - alpha)
                                   + det["centroid"][i] * alpha)
            d["pl_votes"][b] += det["votes"][i]
            d["pl_npts"][b] += npts
            d["pl_nobs"][b] += 1
            dirty[b] = True
        n_pl = int(d["n_planes"])
        slot = min(n_pl, P - 1)
        alloc = ok and not matched and n_pl < P
        if alloc:
            d["pl_coeffs"][slot] = det["coeffs"][i]
            d["pl_centroid"][slot] = det["centroid"][i]
            d["pl_votes"][slot] += det["votes"][i]
            d["pl_valid"][slot] = True
            d["pl_npts"][slot] += npts
            d["pl_nobs"][slot] += 1
            d["n_planes"] = np.asarray(n_pl + 1, np.int32)
            dirty[slot] = True
        pid = b if matched else slot if alloc else -1
        pids.append(pid)
        n_ob = int(d["n_obs"])
        if pid >= 0 and n_ob < Q:
            d["ob_kf"][n_ob] = case["kf"]
            d["ob_plane"][n_ob] = pid
            d["ob_coeffs"][n_ob] = det["local"][i]
            d["ob_conf"][n_ob] = det["votes"][i].sum() / max(npts, 1.0)
            d["ob_quadric"][n_ob] = det["quadric"][i]
            d["ob_valid"][n_ob] = True
            d["n_obs"] = np.asarray(n_ob + 1, np.int32)
    # the voxel keys: a key at a time, over the detections in order
    for k in range(V):
        for i, pid in enumerate(pids):
            if pid >= 0 and det["vox"][i, k] >= 0:
                d["pl_vox"][pid, k] = det["vox"][i, k]
    d["pids"] = pids
    return d


@pytest.mark.parametrize("name", list(ASSOC_CASES))
def test_assoc_order_model_matches_twin(name):
    case = ASSOC_CASES[name]
    model = assoc_model(case)
    sg, dets, kf = selfcheck.assoc_operands(case, "cpu")
    twin = pman.associate_and_update_torch(sg, *dets[:6], kf,
                                           det_quadric=dets[6],
                                           det_vox=dets[7])
    for f in selfcheck.ASSOC_INT_FIELDS:
        np.testing.assert_array_equal(getattr(twin, f).numpy(), model[f],
                                      err_msg=f)
    for f in selfcheck.ASSOC_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(twin, f).numpy(), model[f],
                                   rtol=0, atol=1e-5, err_msg=f)
    pids = model["pids"]
    if name == "two_on_one":
        assert pids[0] == pids[1] == 3
    elif name == "same_plane_twice":
        assert pids[1] == pids[0] >= 10 and pids[3] == -1
    elif name == "argmin_tie":
        assert pids[0] == 3
    elif name == "full_planes":
        assert -1 in pids
    # keys of -1 leave the plane's row as it was
    assert (case["det"]["vox"] < 0).any()
