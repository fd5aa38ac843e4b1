"""K9 (observation grouping): its launch plan against the card's limits,
the kernel's algorithm applied by plain loops against the twin, and the
twin against the reference on out-of-range landmark ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from visual_sgraphs_tpu.parallel import dist_ba as rdist
from visual_sgraphs_tpu_torch.parallel import dist_ba as pdist

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

PORTABLE_CLUSTER = 8  # CTAs a cluster without the non-portable attribute
H100_SMEM = 232448  # shared-memory bytes a CTA may use on the H100


@pytest.mark.parametrize("m, n_pt", [
    (0, 0), (0, 8192), (5, 3), (500, 60), (11000, 8192), (128000, 32768),
    (500000, 10**6), (10**5, 4 * 10**6)])
def test_group_plan_limits(m, n_pt):
    p = pdist.group_plan(m, n_pt)
    assert 1 <= p.cluster <= PORTABLE_CLUSTER
    assert p.smem <= H100_SMEM
    assert p.smem == (pdist.GROUP_HEADER + (pdist.GROUP_WARPS + 3) * p.width
                      + 3 * pdist.GROUP_WARPS * p.seg)
    # every bucket [0, n_pt] in a slice, every entry in a warp segment
    assert p.width % 4 == 0 and p.slices * p.width >= n_pt + 1
    assert (p.slices - 1) * p.width < n_pt + 1
    assert p.cluster * pdist.GROUP_WARPS * p.seg >= m
    assert p.side == p.cluster * pdist.GROUP_WARPS * p.seg
    # more than GROUP_SLICES clusters only when a slice would not fit
    if p.slices > pdist.GROUP_SLICES:
        narrowest = -(-(n_pt + 1) // pdist.GROUP_SLICES)
        assert p.smem - (pdist.GROUP_WARPS + 3) * (p.width - narrowest) \
            > H100_SMEM


def test_group_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        pdist.group_plan(10**7, 100)


def group_by_plan(kf, pt, uvr, valid, n_pt, O):
    """csrc/group_obs.cu step by step on numpy arrays: slices, warp
    segments walked 32 entries at a time with saturating byte counters,
    per-warp offsets, the CTAs' totals summed in rank order, the kept
    entries' writes, the fills, the out-of-range list's ranks and
    n_dropped.  Returns the tables, n_dropped and the writes a slot."""
    m = len(kf)
    p = pdist.group_plan(m, n_pt)
    C, W, seg, width = p.cluster, pdist.GROUP_WARPS, p.seg, p.width
    b_all = np.where(valid, pt, n_pt)
    main = (b_all >= 0) & (b_all <= n_pt)
    out_kf = np.zeros((n_pt, O), np.int32)
    out_uvr = np.zeros((n_pt, O, 3), np.float32)
    out_valid = np.zeros((n_pt, O), bool)
    writes = np.zeros((n_pt, O), int)
    sat = lambda x: np.minimum(O, x)  # noqa: E731
    dropped = 0
    for s in range(p.slices):
        lo = s * width
        rows = np.zeros((C, W, width), int)
        tot = np.zeros((C, width), int)
        lrank = {}
        segs = [(min(m, g * seg), min(m, min(m, g * seg) + seg))
                for g in range(C * W)]
        for c in range(C):
            for w in range(W):
                e0, e1 = segs[c * W + w]
                for b0 in range(e0, e1, 32):
                    es = list(range(b0, min(b0 + 32, e1)))
                    keys = [b_all[e] - lo if main[e] and lo <= b_all[e]
                            < lo + width else -1 for e in es]
                    for j, (e, k) in enumerate(zip(es, keys)):
                        if k >= 0:
                            lrank[e] = sat(rows[c, w, k] + keys[:j].count(k))
                    for k in set(keys) - {-1}:
                        rows[c, w, k] = sat(rows[c, w, k] + keys.count(k))
            run = np.zeros(width, int)
            for w in range(W):
                x = rows[c, w].copy()
                rows[c, w] = run
                run = sat(run + x)
            tot[c] = run
        full = np.zeros(width, int)
        for c in range(C):
            base = np.zeros(width, int)
            for k in range(c):
                base = sat(base + tot[k])
            full = sat(full + tot[c])
            for w in range(W):
                e0, e1 = segs[c * W + w]
                for e in range(e0, e1):
                    b = b_all[e]
                    if not (main[e] and lo <= b < lo + width):
                        continue
                    r = base[b - lo] + rows[c, w, b - lo] + lrank[e]
                    if r >= O:
                        dropped += int(valid[e])
                    elif b < n_pt:
                        out_kf[b, r] = kf[e]
                        out_uvr[b, r] = uvr[e]
                        out_valid[b, r] = True
                        writes[b, r] += 1
        for k in range(min(width, n_pt - lo)):
            for r in range(full[k], O):
                out_kf[lo + k, r] = -1
                out_uvr[lo + k, r] = 0.0
                out_valid[lo + k, r] = False
                writes[lo + k, r] += 1
    # valid ids outside [0, n_pt]: ranked among the same id
    side = np.flatnonzero(~main)
    for i, e in enumerate(side):
        earlier = side[:i]
        dropped += int((pt[earlier] == pt[e]).sum() >= O)
    return (out_kf, out_uvr, out_valid, dropped), writes


def _case(kind: str, rng):
    """(kf, pt, uvr, valid, n_pt, max_obs): 9000 entries, so every warp
    segment takes three steps of 32."""
    m, n_pt, O = 9000, 300, 4
    kf = rng.integers(0, 11, m).astype(np.int32)
    pt = rng.integers(0, n_pt, m).astype(np.int32)
    uvr = rng.normal(size=(m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.2
    if kind == "empty":
        kf, pt, uvr, valid = kf[:0], pt[:0], uvr[:0], valid[:0]
    elif kind == "all_invalid":
        valid[:] = False
    elif kind == "few_landmarks":
        pt = rng.integers(0, 7, m).astype(np.int32)
    elif kind == "out_of_range":
        for bad in (-1, n_pt, n_pt + 1, 10**6):
            pt[rng.uniform(size=m) < 0.03] = bad
    elif kind == "wide":
        n_pt, O = 5000, 12
        pt = rng.integers(0, n_pt, m).astype(np.int32)
    elif kind == "many_slots":
        O = 20
        pt = rng.integers(0, 150, m).astype(np.int32)
    return kf, pt, uvr, valid, n_pt, O


@pytest.mark.parametrize("kind", ["random", "empty", "all_invalid",
                                  "few_landmarks", "out_of_range", "wide",
                                  "many_slots"])
def test_group_kernel_algorithm_matches_twin(kind):
    # the kernel's plan and arithmetic, applied by plain loops, against the
    # twin: tables and n_dropped exactly equal, every slot written once
    rng = np.random.default_rng(3)
    kf, pt, uvr, valid, n_pt, O = _case(kind, rng)
    got, writes = group_by_plan(kf, pt, uvr, valid, n_pt, O)
    want = pdist.group_observations_torch(tp.t(kf), tp.t(pt), tp.t(uvr),
                                          tp.t(valid), n_pt, O)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (writes == 1).all()


def _out_of_range_case(kind: str, rng):
    n_obs, n_pt = 480, 40
    pt = rng.integers(0, n_pt, n_obs).astype(np.int32)
    valid = rng.uniform(size=n_obs) > 0.3
    if kind == "id_n_pt":
        # valid ids equal to n_pt share the invalid entries' bucket
        pt[rng.uniform(size=n_obs) < 0.1] = n_pt
    elif kind == "other_ids":
        # every other id outside [0, n_pt) ranks among its own id
        for bad in (-1, -7, n_pt + 1, 10**6):
            pt[rng.uniform(size=n_obs) < 0.05] = bad
    else:
        for bad in (-1, n_pt, n_pt + 1, 10**6):
            pt[rng.uniform(size=n_obs) < 0.05] = bad
    return pt, valid, n_pt


@pytest.mark.parametrize("kind", ["id_n_pt", "other_ids", "mixed"])
def test_group_observations_out_of_range_ids(kind):
    # exact against the reference, n_dropped included, where valid ids
    # lie outside [0, n_pt)
    rng = np.random.default_rng(11)
    pt, valid, n_pt = _out_of_range_case(kind, rng)
    n_obs, max_obs = pt.shape[0], 4
    kf = rng.integers(0, 11, n_obs).astype(np.int32)
    uvr = rng.normal(size=(n_obs, 3)).astype(np.float32)
    r = rdist.group_observations(jnp.asarray(kf), jnp.asarray(pt),
                                 jnp.asarray(uvr), jnp.asarray(valid),
                                 n_pt, max_obs)
    p = pdist.group_observations(tp.t(kf), tp.t(pt), tp.t(uvr), tp.t(valid),
                                 n_pt, max_obs)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the case drops out-of-range entries, so n_dropped depends on them
    in_range = valid & (pt >= 0) & (pt < n_pt)
    q = pdist.group_observations(tp.t(kf), tp.t(pt), tp.t(uvr),
                                 tp.t(in_range), n_pt, max_obs)
    assert int(p[3]) > int(q[3])
