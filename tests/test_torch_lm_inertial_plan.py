"""K22b's plan and its edge-order reduction on the CPU.

The plan's plain version (``lm_kernels.lm_inertial_plan_torch``: each
edge's whitening ``inertial.init.sqrt_info`` in float64 and the index of
the valid edges) against the reference's ``inertial/init.py::_sqrt_info``
(jitted, float64) on the covariances of the inertial row's keyframe
windows, seeded SPD covariances, a zero padding row and non-finite rows; a
numpy model of the kernel's warp Cholesky (a row of L a lane) and inverse
(a column of W a lane), in its operation order, against the same; the
index against plain loops; and a numpy model of the rows kernel's
reduction (each entry of H and g summed over the valid edges that hold
its variables, in edge order, with the walks and the priors) applied
to per-edge blocks of the twin's own linearisation, against the twin's H
and g.  The CUDA kernels are held against these twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.inertial import init as rinit
from visual_sgraphs_tpu.inertial import preintegration as rpre
from visual_sgraphs_tpu_torch import interop, selfcheck
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.inertial import pipeline
from visual_sgraphs_tpu_torch.inertial import preintegration as ppre
from visual_sgraphs_tpu_torch.optim import graph as pgraph
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk

from torch_parity import one_torch_thread  # noqa: F401

# float64 on both sides: the Choleskys differ only in their order
TWIN_TOL = 1e-10
MODEL_TOL = 1e-12
WALK_G, WALK_A, PRIOR = 1.9e-5, 3.0e-3, 1e4
T_BC = np.float32([0.9998, 0.01, -0.015, 0.005, 0.02, -0.01, 0.03])

_ref_sqrt_info = jax.jit(jax.vmap(rinit._sqrt_info))


_ref_preintegrate = jax.jit(jax.vmap(rpre.preintegrate))


@functools.lru_cache(maxsize=None)
def keyframe_windows(n_edges: int, frames_per_kf: int):
    """(T_wc of the n_edges + 1 keyframes (numpy), the packed float32
    preintegrations (n_edges, PACKED) of the windows between consecutive
    keyframes) over the inertial row's ``orbit`` IMU stream (200 Hz, 30
    fps), ``frames_per_kf`` frames a window, preintegrated by the
    reference (jitted, float32) at non-zero biases."""
    _, traj, samples = selfcheck._inertial_stream("cpu")
    kf = 1 + np.arange(n_edges + 1) * frames_per_kf
    tabs = []
    for e in range(n_edges):
        rows = [s for f in range(kf[e] + 1, kf[e + 1] + 1)
                for s in zip(*samples[f])]
        tabs.append(pipeline.sample_window(rows,
                                           float(samples[kf[e]][2][-1]))[0])
    tab = np.stack(tabs)
    bg = np.broadcast_to(np.float32([0.002, -0.001, 0.0015]), (n_edges, 3))
    ba = np.broadcast_to(np.float32([0.03, -0.02, 0.01]), (n_edges, 3))
    with jax.enable_x64(False):
        pre = _ref_preintegrate(
            jnp.asarray(tab[..., 0:3]), jnp.asarray(tab[..., 3:6]),
            jnp.asarray(tab[..., 6]), jnp.asarray(tab[..., 7] != 0),
            jnp.asarray(bg), jnp.asarray(ba))
    packed = ppre.pack(interop.preint_from_numpy(
        {k: np.asarray(v) for k, v in pre._asdict().items()}))
    return np.asarray(traj, np.float32)[kf], packed


def covariances(case: str) -> np.ndarray:
    """(E, 9, 9) float64 covariances of one case."""
    if case in ("vi", "init"):
        _, pre = (keyframe_windows(9, 4) if case == "vi"
                  else keyframe_windows(63, 2))
        return ppre.unpack(pre).cov.double().numpy()
    rng = np.random.default_rng(7)
    A = rng.normal(size=(16, 9, 9)) * 10.0 ** rng.uniform(-5, -1, (16, 9, 1))
    cov = A @ A.transpose(0, 2, 1)
    if case == "seeded_spd":
        return cov
    if case == "zero_padding":
        cov[3] = 0.0
        return cov
    cov[2, 4, 4] = np.nan
    cov[9, 0, 1] = cov[9, 1, 0] = np.inf
    return cov


CASES = ("vi", "init", "seeded_spd", "zero_padding", "non_finite")


def _plan_of(cov: np.ndarray) -> lmk.InertialPlan:
    """The plan's twin on a chain of edges carrying ``cov``."""
    E = cov.shape[0]
    pre = torch.zeros((E, ppre.PACKED), dtype=torch.float64)
    ppre.unpack(pre).cov.copy_(torch.from_numpy(cov))
    i = torch.arange(E, dtype=torch.int32)
    imu = lmk.ImuRows(pre=pre, edge=torch.stack([i, i + 1], 1),
                      valid=torch.ones(E, dtype=torch.bool),
                      T_bc=torch.from_numpy(T_BC).double(), gs=True,
                      poses=torch.zeros((E + 1, 7), dtype=torch.float64))
    red = lmk.Reduced(vel=torch.zeros((E + 1, 3), dtype=torch.float64))
    return lmk.lm_inertial_plan_torch(imu, red)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def lower_mirrored(cov: np.ndarray) -> np.ndarray:
    """The symmetric matrices of ``cov``'s lower triangles: what the port
    factors (torch's Cholesky reads only the lower triangle), where the
    reference's ``jnp.linalg.cholesky`` factors (C + C^T) / 2."""
    return np.tril(cov) + np.transpose(np.tril(cov, -1), (0, 2, 1))


@pytest.mark.parametrize("case", CASES)
def test_plan_twin_matches_reference_sqrt_info(case):
    # W = L^-1 of cov + 1e-8 I, the identity where not finite: the twin
    # (float64) against the reference's _sqrt_info (float64) on the same
    # symmetric matrix, each edge relative to its largest entry
    cov = covariances(case)
    ref = np.asarray(_ref_sqrt_info(jnp.asarray(lower_mirrored(cov))))
    W = _plan_of(cov).W.numpy().reshape(-1, 9, 9)
    for e in range(cov.shape[0]):
        assert _rel(W[e], ref[e]) <= TWIN_TOL, e
    bad = ~np.isfinite(cov).all(axis=(1, 2))
    assert (ref[bad] == np.eye(9)).all() and (W[bad] == np.eye(9)).all()
    assert bad.any() == (case == "non_finite")


def warp_sqrt_info(cov: np.ndarray) -> np.ndarray:
    """imu.cuh::sqrt_info_warp in numpy, lane by
    lane in the kernel's operation order: lane i keeps row i of L (of the
    covariance's lower triangle), filled column by column from row j's
    entries (lane j's); then lane c solves
    column c of W, row r of L from lane r; the identity unless every
    entry is finite."""
    out = np.empty_like(cov)
    for e, C in enumerate(cov):
        L = np.zeros((9, 9))
        with np.errstate(all="ignore"):
            for j in range(9):
                Lj = L[j, :j].copy()
                s = C[j, j] + 1e-8
                for k in range(j):
                    s -= Lj[k] * Lj[k]
                d = np.sqrt(s)
                L[j, j] = d
                for i in range(j + 1, 9):
                    t = C[i, j]
                    for k in range(j):
                        t -= L[i, k] * Lj[k]
                    L[i, j] = t / d
            W = np.zeros((9, 9))
            for c in range(9):
                for r in range(9):
                    s = 1.0 if r == c else 0.0
                    for k in range(r):
                        s -= L[r, k] * W[k, c]
                    W[r, c] = s / L[r, r]
        out[e] = W if np.isfinite(W).all() else np.eye(9)
    return out


@pytest.mark.parametrize("case", CASES)
def test_warp_sqrt_info_model_matches_reference(case):
    # the kernel's arithmetic, modelled in numpy, against the reference's
    # _sqrt_info in float64: only the order of the same float64 sums differs
    cov = covariances(case)
    ref = np.asarray(_ref_sqrt_info(jnp.asarray(lower_mirrored(cov))))
    W = warp_sqrt_info(cov)
    for e in range(cov.shape[0]):
        assert _rel(W[e], ref[e]) <= MODEL_TOL, e


@pytest.mark.parametrize("case", ["vi", "init"])
def test_whitening_of_asymmetric_covariances(case):
    # a recorded divergence: the float32 preintegrated covariances are
    # asymmetric in their last bits; the reference whitens their
    # symmetric part, the port (twin and kernels) their lower triangle.
    # W then differs by under 1e-6 of its largest entry, far below the
    # float32 reference's own rounding of the residual
    cov = covariances(case)
    assert (cov != np.transpose(cov, (0, 2, 1))).any()
    ref = np.asarray(_ref_sqrt_info(jnp.asarray(cov)))
    W = _plan_of(cov).W.numpy().reshape(-1, 9, 9)
    errs = [_rel(W[e], ref[e]) for e in range(cov.shape[0])]
    assert 0.0 < max(errs) <= 1e-6


def edge_index(edge: np.ndarray, valid: np.ndarray, R: int):
    """The plan's index by plain loops: (rptr, redge, vedge, nvalid)."""
    E = edge.shape[0]
    ok = [bool(valid[e]) and all(0 <= x < R for x in edge[e])
          for e in range(E)]
    vedge = [e for e in range(E) if ok[e]]
    rptr, redge = [0], []
    for r in range(R):
        redge += [e for e in range(E) if ok[e] and r in edge[e]]
        rptr.append(len(redge))
    pad = lambda xs, n: np.int32(xs + [-1] * (n - len(xs)))  # noqa: E731
    return (np.int32(rptr), pad(redge, 2 * E), pad(vedge, E),
            np.int32([len(vedge)]))


@pytest.mark.parametrize("kind", ["chain", "scrambled"])
def test_plan_edge_index(kind):
    # the valid edges in edge order, and each row's valid edges (i or j on
    # it, once when i == j) in edge order; invalid edges and edges with a
    # row outside the layout are left out
    rng = np.random.default_rng(11)
    R, E = 12, 40
    if kind == "chain":
        i = np.arange(R - 1)
        edge = np.stack([i, i + 1], 1)
        E = R - 1
    else:
        edge = rng.integers(-1, R + 1, (E, 2))
        edge[5] = [4, 4]
    valid = rng.uniform(size=E) < 0.8
    pre = torch.zeros((E, ppre.PACKED), dtype=torch.float64)
    imu = lmk.ImuRows(pre=pre, edge=torch.from_numpy(np.int32(edge)),
                      valid=torch.from_numpy(valid),
                      T_bc=torch.from_numpy(T_BC).double(), gs=True)
    plan = lmk.lm_inertial_plan_torch(
        imu, lmk.Reduced(vel=torch.zeros((R, 3), dtype=torch.float64)))
    for got, want in zip(plan[1:5], edge_index(edge, valid, R)):
        np.testing.assert_array_equal(got.numpy(), want)


def inertial_problem(gs: bool):
    """A float64 problem on the inertial row's keyframe windows: the VI
    BA's 9 edges over 10 slots (poses, velocities, per-slot biases, bias
    walks; edge 3 invalid), or an initialisation's 15 edges over 16
    keyframes (fixed poses, shared biases, gravity direction and scale,
    bias priors; edge 5 invalid)."""
    rng = np.random.default_rng(5)
    n_edges = 15 if gs else 9
    T_wc, pre = keyframe_windows(n_edges, 3 if gs else 4)
    n = n_edges + 1
    f64 = torch.float64
    T_cw = lie.se3_inverse(torch.from_numpy(T_wc)).double()
    pre = pre.double()
    i = torch.arange(n_edges, dtype=torch.int32)
    valid = torch.ones(n_edges, dtype=torch.bool)
    valid[5 if gs else 3] = False
    vel = torch.from_numpy(rng.normal(size=(n, 3)) * 0.5)
    if gs:
        q = torch.tensor([[0.95, 0.2, -0.2, 0.1]], dtype=f64)
        red = lmk.Reduced(vel=vel, bg=torch.full((1, 3), 0.002, dtype=f64),
                          ba=torch.full((1, 3), -0.01, dtype=f64),
                          gdir=q / q.norm(), scale=torch.full((1, 1), 1.05,
                                                              dtype=f64))
        extra = dict(poses=T_cw, prior=PRIOR)
    else:
        red = lmk.Reduced(
            pose=lie.se3_boxplus(T_cw, torch.from_numpy(
                rng.normal(size=(n, 6)) * 0.01)),
            vel=vel, bg=torch.from_numpy(rng.normal(size=(n, 3)) * 1e-3),
            ba=torch.from_numpy(rng.normal(size=(n, 3)) * 1e-2))
        dt = torch.clamp(ppre.unpack(pre).dt, min=1e-3)
        extra = dict(info_g=1.0 / (WALK_G ** 2 * dt),
                     info_a=1.0 / (WALK_A ** 2 * dt))
    imu = lmk.ImuRows(pre=pre, edge=torch.stack([i, i + 1], 1), valid=valid,
                      T_bc=torch.from_numpy(T_BC).double(), gs=gs, **extra)
    return imu, red


def _col(offs: dict, c: int):
    fam = max((k for k in lmk.FAMILIES if k in offs and offs[k] <= c),
              key=lambda k: offs[k])
    rel = c - offs[fam]
    return fam, rel // lmk.TANGENT[fam], rel % lmk.TANGENT[fam]


def _dirs(gs: bool, col, i: int, j: int) -> list:
    """The kernel's column map: the edge's directions of ``col``."""
    fam, row, k = col
    base = {"vel": 0, "bg": 6, "ba": 9, "gdir": 12, "scale": 14} if gs \
        else {"pose": 0, "vel": 12, "bg": 18, "ba": 21}
    if fam in ("pose", "vel"):
        t = lmk.TANGENT[fam]
        return ([base[fam] + k] if row == i else []) \
            + ([base[fam] + t + k] if row == j else [])
    if gs or row == j:
        return [base[fam] + k]
    return []


def lane_tree(terms: np.ndarray) -> float:
    """The kernel's sum of ``terms`` (in valid-edge order) over a warp:
    lane l adds terms l, l + 32, ... in order, then a butterfly of
    shuffles (``part += shfl_xor(part, off)``, off = 16 .. 1) adds the
    lanes; lane 0's sum is taken."""
    part = np.zeros(32)
    for p, t in enumerate(terms):
        part[p % 32] += t
    for off in (16, 8, 4, 2, 1):
        part = part + part[np.arange(32) ^ off]
    return float(part[0])


def model_reduce(imu, red, plan, blk, grd):
    """The rows kernel's sums in numpy: each entry of H over the valid
    edges of its row variable's edge list, each entry of g over every
    valid edge (the kernel walks the column's own edges: the same terms),
    in edge order, each edge's staged terms (the row's i then j
    direction, against the column's i then j) then its walk term; then
    the prior.  The initialisation's shared columns of its shared rows
    and of g are summed by ``lane_tree`` (its other shared-row entries
    are the transposes of per-slot rows' entries, the same terms in the
    same order)."""
    gs, offs = imu.gs, lmk.offsets(red)
    D = offs["D"]
    edge = imu.edge.numpy()
    rptr, redge = plan.rptr.numpy(), plan.redge.numpy()
    vlist = plan.vedge.numpy()[:int(plan.nvalid[0])]
    cols = [_col(offs, c) for c in range(D)]
    slot = ("pose", "vel") if gs else ("pose", "vel", "bg", "ba")
    lists = [redge[rptr[r]:rptr[r + 1]] if fam in slot else vlist
             for fam, r, _ in cols]
    info = {"bg": imu.info_g, "ba": imu.info_a}
    vals = {k: v.numpy() for k, v in red._asdict().items() if v is not None}

    def coef(col, i, j):
        return float(col[1] == j) - float(col[1] == i)

    H, g = np.zeros((D, D)), np.zeros(D)
    for c1, a in enumerate(cols):
        for c2, b in enumerate(cols):
            walk = (not gs and a[0] in ("bg", "ba") and a[0] == b[0]
                    and a[2] == b[2])
            s = 0.0
            for e in lists[c1]:
                i, j = edge[e]
                for x in _dirs(gs, a, i, j):
                    for y in _dirs(gs, b, i, j):
                        s += blk[e, x, y]
                ca, cb = coef(a, i, j), coef(b, i, j)
                if walk and ca and cb:
                    s += float(info[a[0]][e]) * ca * cb
            if gs and a[0] != "vel" and b[0] != "vel":
                s = lane_tree([blk[e, _dirs(gs, a, *edge[e])[0],
                                   _dirs(gs, b, *edge[e])[0]]
                               for e in vlist])
            if gs and c1 == c2 and a[0] in ("bg", "ba"):
                s += imu.prior
            H[c1, c2] = s
    for c, col in enumerate(cols):
        fam, _, k = col
        s = 0.0
        for e in vlist:
            i, j = edge[e]
            for x in _dirs(gs, col, i, j):
                s += grd[e, x]
            cc = coef(col, i, j)
            if not gs and fam in ("bg", "ba") and cc:
                res = vals[fam][j, k] - vals[fam][i, k]
                s += float(info[fam][e]) * cc * res
        if gs and fam != "vel":
            s = lane_tree([grd[e, _dirs(gs, col, *edge[e])[0]]
                           for e in vlist])
        if gs and fam in ("bg", "ba"):
            s += imu.prior * vals[fam][0, k]
        g[c] = s
    return H, g


@pytest.mark.parametrize("variant", ["vi", "init"])
def test_edge_order_reduction_model_matches_twin(variant):
    # per-edge blocks w J^T J, w J^T r of the twin's own linearisation
    # (graph.linearize_batch on the preintegration batch; the
    # initialisation's fixed poses left out), reduced as the rows kernel
    # reduces them, equal to the twin's dense H and g up to the order of
    # the float64 sums, invalid edges included
    gs = variant == "init"
    imu, red = inertial_problem(gs)
    problem, _ = lmk._inertial_problem(imu, red)
    r, jacs, w = pgraph.linearize_batch(problem.factors[0], problem.families)
    J = torch.cat(jacs[2:] if gs else jacs, dim=-1)
    blk = (w[:, None, None] * J.transpose(1, 2) @ J).numpy()
    grd = (w[:, None] * torch.einsum("erd,er->ed", J, r)).numpy()
    plan = lmk.lm_inertial_plan_torch(imu, red)
    H, g = model_reduce(imu, red, plan, blk, grd)
    tH, tg = lmk.lm_inertial_assemble_torch(imu, red)
    tH, tg = tH.numpy(), tg.numpy()
    d = np.sqrt(np.maximum(np.abs(np.diag(tH)), 1e-30))
    assert (np.abs(H - tH) / np.outer(d, d)).max() <= MODEL_TOL
    assert (np.abs(g - tg) / d).max() <= MODEL_TOL * (np.abs(tg) / d).max()
    assert not imu.valid.all() and int(plan.nvalid[0]) == len(imu.valid) - 1
