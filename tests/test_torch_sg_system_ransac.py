"""K21's reduced system and plan and K13's one-launch extraction, port
against reference and against numpy models of the kernels (the kernels'
plain twins stand in on the CPU):

- ``sg_system_torch`` (the scene-graph H, g with the landmarks' keyframe
  block: S = H + S_kf, rhs = [rhs_kf - g_kf | -g_rest]) against the
  reference's ``_assemble_dense`` plus ``fast_ba.py:388-389``;
- the plan's twin (``sg_plan_torch``) against a numpy model of the plan
  kernel's walk: live items in item order, each coupled pair's
  contributors (n, si, sj) found from the shorter variable list, exactly;
- a numpy model of the system kernel's owner sums (each entry of S and
  rhs summed by one owner in the plan's contributor order, in float64)
  against the twin;
- a numpy model of K13's cluster split (each CTA's hypotheses, the
  summation order of every score and refit sum, the rounds chained over
  the remaining mask) against ``extract_planes_torch`` on the reference's
  RANSAC draws: the same winners, planes and assignment.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.optim import fast_ba
from visual_sgraphs_tpu_torch.optim.graph import (
    GraphProblem,
    linearize_batch,
    plane_family,
    point_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.profile_slice import _implied_winners
from visual_sgraphs_tpu_torch.scenegraph import plane_fit as pfit

from test_torch_freespace import _reference_assemble
from test_torch_scenegraph import hypotheses
from torch_parity import one_torch_thread  # noqa: F401

LIVE = selfcheck.SG_LIVE


def _small(seed: int = 3, **over) -> dict:
    """Seeded operands at L = 3, P = 8, R = 2, Dn = 2, Q = 32 with live
    and dead items of every type: room 0 a 4-wall room with two wall slots
    on one plane, room 1 a 2-wall corridor, one door live and one dead."""
    d = selfcheck.sg_assemble_inputs(seed=seed, L=3, P=8, R=2, Dn=2, Q=32)
    d["room2_valid"] = np.array([False, True])
    d["door_valid"] = np.array([True, False])
    d["quad_valid"] = d["ob_valid"] & (np.arange(32) % 3 != 0)
    d.update(over)
    return d


def _keyframe_block(d: dict, seed: int = 5):
    kd = 6 * d["poses"].shape[0]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(kd, kd))
    return A @ A.T, rng.normal(size=kd) * 3.0


# ------------------------------------------------ the system's twin


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sg_system_twin_matches_reference(dtype):
    # both packages in one dtype: S and rhs within 1e-5 of the largest
    # entry (float32 without the Gij quadric, whose sqrt(pi^T G pi)
    # cancels in float32 in each package in another way)
    d = _small()
    assert all(d[k].any() for k in LIVE)
    assert not all(d[k].all() for k in LIVE)
    if dtype == np.float32:
        d["quad_valid"] = np.zeros_like(d["quad_valid"])
    d = {k: v.astype(dtype) if v.dtype.kind == "f" else v
         for k, v in d.items()}
    S_kf, rhs_kf = (x.astype(dtype) for x in _keyframe_block(d))
    kd = S_kf.shape[0]
    rH, rg = _reference_assemble({k: jnp.asarray(v) for k, v in d.items()})
    rS = np.asarray(rH.at[:kd, :kd].add(jnp.asarray(S_kf)))
    rrhs = np.asarray((-rg).at[:kd].add(jnp.asarray(rhs_kf)))
    ops = selfcheck.sg_assemble_operands(
        d, "cpu", getattr(torch, np.dtype(dtype).name))
    pS, prhs = fast_ba.sg_system(*ops, fast_ba.sg_plan(ops[4], 3, 8),
                                 torch.from_numpy(S_kf),
                                 torch.from_numpy(rhs_kf))
    assert pS.dtype == getattr(torch, np.dtype(dtype).name)
    np.testing.assert_allclose(pS.numpy(), rS, rtol=0,
                               atol=1e-5 * np.abs(rS).max())
    np.testing.assert_allclose(prhs.numpy(), rrhs, rtol=0,
                               atol=1e-5 * np.abs(rrhs).max())


# ------------------------------------------------ the plan


def _slot_vars_np(d: dict, L: int, P: int) -> list[list[int]]:
    """Each item's slot variables, items in the kernel's order."""
    R = d["room_idx"].shape[0]
    out = []
    for ob in d["ob_idx"]:
        out.append([int(ob[0]), L + int(ob[1])])
    out += [list(v) for v in out]
    for ns in (5, 3):
        for rm in d["room_idx"]:
            out.append([L + P + int(rm[0])] + [L + int(w) for w in
                                               rm[1:ns]])
    for dr in d["door_idx"]:
        out.append([L + P + R + int(dr[0]), L + P + int(dr[1])])
    return out


def plan_model(d: dict, L: int, P: int) -> dict:
    """A numpy model of the plan kernel: live items in order, each
    variable's (n, s) list, then for each coupled pair (a <= b, index
    order) the walk of the shorter list (a's on ties) over its distinct
    items, slots on a then slots on b in order."""
    R, Dn, Q = (d["room_idx"].shape[0], d["door_idx"].shape[0],
                d["ob_idx"].shape[0])
    NI, V, np_cap, ne_cap = fast_ba.sg_plan_sizes(L, P, R, Dn, Q)
    flags = np.concatenate([d[k] for k in LIVE])
    sv = _slot_vars_np(d, L, P)
    live = [i for i in range(NI) if flags[i]]
    ivar = [sv[i] for i in live]
    lists = [[] for _ in range(V)]
    for n, iv in enumerate(ivar):
        for s, v in enumerate(iv):
            lists[v].append((n, s))
    pmap = np.zeros((V, V), bool)
    for iv in ivar:
        for a in iv:
            for b in iv:
                pmap[a, b] = True
    pairs = [a * V + b for a in range(V) for b in range(a, V) if pmap[a, b]]
    pptr, pent = [], []
    for key in pairs:
        a, b = divmod(key, V)
        walk = lists[b] if len(lists[b]) < len(lists[a]) else lists[a]
        pptr.append(len(pent))
        prev = -1
        for n, _ in walk:
            if n == prev:
                continue
            prev = n
            for si, va in enumerate(ivar[n]):
                for sj, vb in enumerate(ivar[n]):
                    if va == a and vb == b:
                        pent.append(n * 25 + si * 5 + sj)

    def pad(x, n, fill):
        return np.array(list(x) + [fill] * (n - len(x)), np.int32)

    c = d["ob_coeffs"].astype(np.float64)[:, :3]
    az = np.arctan2(c[:, 1], c[:, 0])
    el = np.arctan2(c[:, 2], np.sqrt(c[:, 0] ** 2 + c[:, 1] ** 2))
    ca, sa, ce, se = np.cos(az), np.sin(az), np.cos(el), np.sin(el)
    rot = np.stack([ca * ce, -sa, -ca * se, sa * ce, ca, -sa * se, se,
                    0 * az, ce], 1)
    epos = np.full(25 * NI, -1, np.int32)
    epos[pent] = np.arange(len(pent))
    return dict(live=pad(live, NI, -1), pairs=pad(pairs, np_cap, -1),
                pptr=pad(pptr, np_cap + 1, len(pent)),
                pent=pad(pent, ne_cap, -1), epos=epos, pmap=pmap, rot=rot,
                meta=np.array([len(live), len(pairs)], np.int32))


PLAN_CASES = {
    "small": lambda: (_small(), 3, 8),
    "main_shapes": lambda: (selfcheck.sg_assemble_inputs(seed=2), 11, 64),
    "all_dead": lambda: (_small(**{k: np.zeros_like(_small()[k])
                                   for k in LIVE}), 3, 8),
    "one_type": lambda: (_small(quad_valid=np.zeros(32, bool),
                                room4_valid=np.zeros(2, bool),
                                room2_valid=np.zeros(2, bool),
                                door_valid=np.zeros(2, bool)), 3, 8),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_sg_plan_twin_matches_kernel_model(case):
    d, L, P = PLAN_CASES[case]()
    fac = selfcheck.sg_assemble_operands(d, "cpu")[4]
    t = fast_ba.sg_plan_torch(fac, L, P)
    m = plan_model(d, L, P)
    for k in ("live", "pairs", "pptr", "pent", "epos", "pmap", "meta"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), m[k], err_msg=k)
    np.testing.assert_allclose(t.rot.numpy(), m["rot"], rtol=0, atol=1e-15)
    if case == "small":
        # room 0's two wall slots on one plane: its diagonal pair holds
        # both slots' blocks and the cross terms
        assert int(t.meta[0]) > 0 and int(t.meta[1]) > 0


# ------------------------------------------------ the owner sums


def _item_blocks(ops, fac):
    """Per item (the kernel's order) w J^T J and w J^T r (float64), from
    the twin's generic linearisation."""
    poses, planes, rooms, doors = ops
    problem = GraphProblem(
        families={"kf": se3_family(poses), "plane": plane_family(planes),
                  "room": point_family(rooms), "door": se3_family(doors)},
        factors=fast_ba.sg_factor_batches(fac))
    fams = {k: dataclasses.replace(problem.families[k], values=v)
            for k, v in zip(("kf", "plane", "room", "door"), ops)}
    M, G = [], []
    for batch in problem.factors:
        r, jacs, w = linearize_batch(batch, fams)
        J = torch.cat(jacs, dim=-1).numpy()
        r, w = r.numpy(), w.numpy()
        M += list(w[:, None, None] * np.einsum("mki,mkj->mij", J, J))
        G += list(w[:, None] * np.einsum("mki,mk->mi", J, r))
    return M, G


def owner_sums_model(ops, fac, plan, S_kf, rhs_kf, L, P, R, Dn):
    """A numpy model of the system kernel.  Phase 1: each live item writes
    its blocks of w J^T J, and on a diagonal pair of w J^T r (0 where the
    slots differ), at their contributor positions (``plan.epos``).  Phase
    2: every entry of S in an uncoupled pair and of rhs of an untouched
    variable from S_kf / rhs_kf (or 0); each coupled pair's entries (the
    upper triangle of a diagonal pair, mirrored) summed by one owner over
    the pair's contributor positions in order, the diagonal pair's owners
    of rhs likewise.  Returns (S, rhs, times each entry of S was written,
    whether every contributor block was written)."""
    M, G = _item_blocks(ops, fac)
    V = L + P + R + Dn
    widths = [6] * L + [3] * (P + R) + [6] * Dn
    cols = np.concatenate([[0], np.cumsum(widths)]).astype(int)
    D, kd = cols[-1], 6 * L

    def dirs(t, s):
        return 3 * s if t in (2, 3) else (0 if s == 0 else 6)

    def var_of(c):
        return int(np.searchsorted(cols, c, side="right") - 1)

    Q = fac.ob_idx.shape[0]
    types = np.repeat([0, 1, 2, 3, 4], [Q, Q, R, R, Dn])
    live, pairs = plan.live.numpy(), plan.pairs.numpy()
    pptr, epos, pmap = plan.pptr.numpy(), plan.epos.numpy(), plan.pmap.numpy()
    n_ent = int(pptr[int(plan.meta[1])])
    iv = fast_ba._slot_vars(fac, L, P).numpy()
    blocks, gblocks = np.full((n_ent, 36), np.nan), np.full((n_ent, 6), np.nan)
    for n in range(int(plan.meta[0])):
        i = int(live[n])
        t = types[i]
        ns = int((iv[i] >= 0).sum())
        for si in range(ns):
            for sj in range(ns):
                a, b = iv[i, si], iv[i, sj]
                if a > b:
                    continue
                k = epos[n * 25 + si * 5 + sj]
                wa, wb = widths[a], widths[b]
                blocks[k, :wa * wb] = M[i][dirs(t, si):dirs(t, si) + wa,
                                           dirs(t, sj):dirs(t, sj) + wb
                                           ].reshape(-1)
                if a == b:
                    gblocks[k, :wa] = (G[i][dirs(t, si):dirs(t, si) + wa]
                                       if si == sj else 0.0)
    S, rhs = np.zeros((D, D)), np.zeros(D)
    written = np.zeros((D, D), int)
    for r in range(D):
        for c in range(D):
            if not pmap[var_of(r), var_of(c)]:
                S[r, c] = S_kf[r, c] if (r < kd and c < kd) else 0.0
                written[r, c] += 1
        if not pmap[var_of(r), var_of(r)]:
            rhs[r] = (rhs_kf[r] if r < kd else 0.0) - 0.0
    for m in range(int(plan.meta[1])):
        a, b = divmod(int(pairs[m]), V)
        ks = range(pptr[m], pptr[m + 1])
        for ca in range(widths[a]):
            for cb in range(widths[b]):
                if a == b and ca > cb:
                    continue
                acc = 0.0
                for k in ks:
                    acc += blocks[k, ca * widths[b] + cb]
                r, c = cols[a] + ca, cols[b] + cb
                for rr, cc in {(r, c), (c, r)}:
                    kf = a < L and b < L
                    S[rr, cc] = acc + (S_kf[rr, cc] if kf else 0.0)
                    written[rr, cc] += 1
        if a == b:
            for ca in range(widths[a]):
                g = 0.0
                for k in ks:
                    g += gblocks[k, ca]
                r = cols[a] + ca
                rhs[r] = -g + (rhs_kf[r] if a < L else 0.0)
    wv = np.array(widths)
    used = [wv[pairs[m] // V] * wv[pairs[m] % V]
            for m in range(int(plan.meta[1]))
            for _ in range(pptr[m], pptr[m + 1])]
    complete = all(np.isfinite(blocks[k, :u]).all()
                   for k, u in enumerate(used))
    return S, rhs, written, complete


@pytest.mark.parametrize("case", ["small", "one_type"])
def test_owner_sums_model_matches_twin(case):
    # float64 throughout: every entry written once, S and rhs within 1e-12
    # of the twin's largest entries (the sums run in another order)
    d, L, P = PLAN_CASES[case]()
    R, Dn = d["room_idx"].shape[0], d["door_idx"].shape[0]
    ops = selfcheck.sg_assemble_operands(d, "cpu", torch.float64)
    fac = ops[4]
    S_kf, rhs_kf = _keyframe_block(d)
    plan = fast_ba.sg_plan_torch(fac, L, P)
    S, rhs, written, complete = owner_sums_model(ops[:4], fac, plan, S_kf,
                                                 rhs_kf, L, P, R, Dn)
    tS, trhs = fast_ba.sg_system_torch(*ops, plan, torch.from_numpy(S_kf),
                                       torch.from_numpy(rhs_kf))
    assert (written == 1).all() and complete
    np.testing.assert_array_equal(S, S.T)
    np.testing.assert_allclose(S, tS.numpy(), rtol=0,
                               atol=1e-12 * np.abs(tS.numpy()).max())
    np.testing.assert_allclose(rhs, trhs.numpy(), rtol=0,
                               atol=1e-12 * np.abs(trhs.numpy()).max())


# ------------------------------------------------ K13's split

PT = 256  # csrc/ransac.cu: the summation order's threads
F32 = np.float32


def _butterfly(v):
    """vsg_warp_sum over the last axis (32 lanes), float32."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(F32)
    return v[..., 0]


def _tree_sums(x):
    """The kernel's order of a sum over points: share t = n % 256 summed
    in point order, a butterfly over each 32 consecutive shares, the 8
    trees added in order to 0.  ``x`` (..., N) float32; N % 256 == 0."""
    k = x.shape[-1] // PT
    parts = x.reshape(x.shape[:-1] + (k, PT // 32, 32))
    acc = np.zeros(parts.shape[:-3] + (PT // 32, 32), F32)
    for j in range(k):
        acc = (acc + parts[..., j, :, :]).astype(F32)
    trees = _butterfly(acc)
    s = np.zeros(x.shape[:-1], F32)
    for j in range(PT // 32):
        s = (s + trees[..., j]).astype(F32)
    return s


def _fma_sum(w, p, mask):
    """The centroid's ``cs += wn * p`` (an FMA) in the kernel's order."""
    t = np.where(mask, w.astype(np.float64) * p, 0.0)
    k = t.shape[-1] // PT
    parts = t.reshape(k, PT // 32, 32)
    acc = np.zeros((PT // 32, 32), F32)
    for j in range(k):
        acc = (acc.astype(np.float64) + parts[j]).astype(F32)
    trees = _butterfly(acc)
    s = F32(0)
    for j in range(PT // 32):
        s = F32(s + trees[j])
    return s


def _dot3(a, b):
    return ((a[..., 0] * b[..., 0]).astype(F32)
            + (a[..., 1] * b[..., 1]).astype(F32)).astype(F32) \
        + (a[..., 2] * b[..., 2]).astype(F32)


def _planes(pts, idx):
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    a, b = p1 - p0, p2 - p0
    n = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                  a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                  a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1).astype(F32)
    nn = np.sqrt(_dot3(n, n).astype(F32)).astype(F32)
    n = (n / np.maximum(nn, F32(1e-12))[:, None]).astype(F32)
    return n, (-_dot3(n, p0)).astype(F32), nn < F32(1e-8)


def _jacobi(a):
    """csrc/ransac.cu::smallest_eigenvector in float32."""
    a = a.astype(F32).copy()
    v = np.eye(3, dtype=F32)
    for _ in range(32):
        off = abs(a[0, 1]) + abs(a[0, 2]) + abs(a[1, 2])
        diag = abs(a[0, 0]) + abs(a[1, 1]) + abs(a[2, 2])
        if off <= F32(1e-12) * diag or off == 0:
            break
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[p, q]
            if apq == 0:
                continue
            theta = F32((a[q, q] - a[p, p]) / (F32(2) * apq))
            if abs(theta) > F32(1e18):
                t = F32(F32(0.5) / theta)
            else:
                t = F32((F32(1) if theta >= 0 else F32(-1))
                        / (abs(theta) + np.sqrt(F32(theta * theta + 1))))
            c = F32(F32(1) / np.sqrt(F32(t * t + 1)))
            s = F32(t * c)
            a[p, p] -= t * apq
            a[q, q] += t * apq
            a[p, q] = a[q, p] = 0
            r = 3 - p - q
            arp, arq = a[r, p], a[r, q]
            a[r, p] = a[p, r] = c * arp - s * arq
            a[r, q] = a[q, r] = s * arp + c * arq
            vp, vq = v[:, p].copy(), v[:, q].copy()
            v[:, p], v[:, q] = c * vp - s * vq, s * vp + c * vq
    k = int(np.argmin(np.diag(a)))
    return (v[:, k] / max(np.linalg.norm(v[:, k]), 1e-30)).astype(F32)


def ransac_model(pts, valid, w, hyp, thresh, min_inliers, cluster):
    """A numpy model of the one-launch K13 on a cluster of ``cluster``
    CTAs.  Returns (coeffs, valid, assign, winners)."""
    N, H = pts.shape[0], hyp.shape[1]
    thresh, min_inl = F32(thresh), F32(min_inliers)
    rem = valid.copy()
    weff = np.where(valid, w, 0).astype(F32)
    assign = np.full(N, -1, np.int32)
    per_h = -(-H // cluster)
    coeffs, pvalid, winners = [], [], []
    for rnd in range(hyp.shape[0]):
        idx = hyp[rnd]
        n, c, degen = _planes(pts, idx)
        dist = np.abs(_dot3(n[:, None, :], pts[None]) + c[:, None])
        scores = _tree_sums(np.where(dist < thresh, weff, 0).astype(F32))
        scores = np.where(rem[idx].all(1) & ~degen, scores, F32(-1))
        # each CTA's best of its share, then the cluster's in CTA order
        best = (F32(-3e38), 2 ** 31 - 1)
        for cta in range(cluster):
            for h in range(cta * per_h, min(H, (cta + 1) * per_h)):
                if scores[h] > best[0] or (scores[h] == best[0]
                                           and h < best[1]):
                    best = (scores[h], h)
        win = best[1]
        winners.append(win)
        inl = rem & (dist[win] < thresh)
        cs = [_fma_sum(weff, np.ones(N, F32), inl)] + [
            _fma_sum(weff, pts[:, k], inl) for k in range(3)]
        wsum = max(cs[0], F32(1e-12))
        cen = np.array([cs[k + 1] / wsum for k in range(3)], F32)
        q = ((pts - cen) * np.sqrt(weff)[:, None]).astype(F32)
        sc = np.zeros((3, 3), F32)
        for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
            sc[i, j] = sc[j, i] = _fma_sum(q[:, i], q[:, j], inl)
        nv = _jacobi(sc)
        cc = -F32(nv @ cen)
        nrm = max(F32(np.linalg.norm(nv)), F32(1.17549435e-38))
        plane = (np.append(nv, cc) / nrm * (-1 if cc / nrm < 0 else 1)
                 ).astype(F32)
        dref = np.abs(_dot3(plane[None, :3], pts) + plane[3])
        take = rem & (dref < thresh)
        good = _tree_sums(np.where(take, weff, 0).astype(F32)) >= min_inl
        coeffs.append(plane if good else np.zeros(4, F32))
        pvalid.append(good)
        if good:
            assign[take] = rnd
            rem &= ~take
            weff = np.where(take, 0, weff).astype(F32)
    return np.stack(coeffs), np.array(pvalid), assign, winners


def _plane_cloud(seed: int, N: int = 2048, unit: bool = True):
    """Points on four planes of a room corner (floor, two walls, ceiling)
    and some clutter, 2 cm noise, in a camera frame; weights 1 (as the
    synthetic scenes give) or seeded in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    k = N // 5
    u, v = rng.uniform(-2, 2, (2, N))
    pts = np.empty((N, 3))
    pts[:k] = np.stack([u[:k], np.full(k, 1.2), 3 + v[:k]], 1)
    pts[k:2 * k] = np.stack([np.full(k, -1.5), u[k:2 * k],
                             3 + v[k:2 * k]], 1)
    pts[2 * k:3 * k] = np.stack([u[2 * k:3 * k], v[2 * k:3 * k],
                                 np.full(k, 5.0)], 1)
    pts[3 * k:4 * k] = np.stack([u[3 * k:4 * k], np.full(k, -1.3),
                                 3 + v[3 * k:4 * k]], 1)
    pts[4 * k:] = rng.uniform(-2, 2, (N - 4 * k, 3)) + [0, 0, 3]
    pts += rng.normal(size=pts.shape) * 0.01
    valid = rng.uniform(size=N) > 0.05
    w = np.ones(N) if unit else rng.uniform(0.5, 1.5, N)
    return pts.astype(F32), valid, w.astype(F32)


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("weights", ["unit", "seeded"])
def test_ransac_split_model_matches_twin(cluster, weights):
    # the reference's draws for two keys: the model's winners, plane flags
    # and assignment equal to the twin's, planes within PLANE_TOL; at
    # least three of the corner's four planes found (every round's refit
    # and removal compared)
    pts, valid, w = _plane_cloud(7, unit=weights == "unit")
    for key in (0, 1):
        hyp = hypotheses(jax.random.PRNGKey(key))
        mc, mv, ma, mw = ransac_model(pts, valid, w, hyp, 0.04, 150.0,
                                      cluster)
        args = (torch.from_numpy(pts), torch.from_numpy(valid),
                torch.from_numpy(w), torch.from_numpy(hyp), 0.04, 150.0)
        tc, tv, ta = pfit.extract_planes_torch(*args)
        assert mw == _implied_winners(*args[:4], ta, 0.04)
        np.testing.assert_array_equal(mv, tv.numpy())
        np.testing.assert_array_equal(ma, ta.numpy())
        np.testing.assert_allclose(mc, tc.numpy(), rtol=0,
                                   atol=selfcheck.PLANE_TOL)
        assert mv.sum() >= 3
