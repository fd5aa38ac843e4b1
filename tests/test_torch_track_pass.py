"""The tracking pass (K5's redesign, ``features.match.track_pass``) and
K20's warp elimination on the CPU.

- The twin (``track_pass_torch``) against the reference's pass: the
  projection and gates of ``slam/tracking.py:285-301``, ``match_window``
  (``features/match.py:104``) and the gathers ``frame.uv[slot]`` /
  ``frame.depth[slot]``, jitted, on seeded cases: points on the window's
  edge and one float32 ulp past it, Hamming ties, several queries on one
  target, all-invalid input, -1-padded tables; integers exact, pixels
  within 1e-4 of the float64 reference.
- The kernel's cell plan (``track_pass_plan``, ``csrc/track_pass.cu``)
  applied by a plain loop: the counting sort by cell, each grid row's run
  of the window's bounding box, the best two by (distance, index), the
  claims; equal to the twin's full scan on the same cases.
- K20's elimination (``csrc/vi_pose.cu::eliminate``: a row a lane, the
  pivot by an arg-max over the lanes, the exchanges a permutation of the
  lanes) applied by a plain loop in the kernel's order: equal to
  ``lie.cuh::solve_dense``'s order of operations and within 1e-6 of the
  largest step of the twin's float64 solve on seeded 15x15 systems whose
  diagonal spans ~1e-10 to 1e7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import cameras as rcam
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.features import match as rmatch
from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.features import match as pmatch
from visual_sgraphs_tpu_torch.slam.frame import FrameObs

from torch_parity import one_torch_thread  # noqa: F401

BIG = 10_000
H100_SMEM = 232448  # shared-memory bytes a CTA may use on the H100
FIELDS = ("uv_pred", "vis", "vis_pt", "match", "dist", "ok", "slot",
          "uv_m", "depth_m", "n_match")


@functools.partial(jax.jit, static_argnames=("img_wh",))
def ref_pass(pt_pos, pt_desc, ids, T, cam, kp_uv, kp_desc, kp_valid,
             kp_depth, radius, img_wh):
    """The reference's pass (slam/tracking.py:285-302): predict_uv, the
    window match, the gathers."""
    lvalid = ids >= 0
    safe = jnp.maximum(ids, 0)
    p_cam = rlie.se3_apply(T, pt_pos[safe])
    uvp = rcam.project_pinhole(cam, p_cam)
    vis = (p_cam[:, 2] > 0.05) & lvalid
    if img_wh is not None:
        w, h = img_wh
        vis = vis & (uvp[:, 0] >= 0) & (uvp[:, 0] < w) & \
            (uvp[:, 1] >= 0) & (uvp[:, 1] < h)
    match, dist = rmatch.match_window(pt_desc[safe], uvp, vis, kp_desc, kp_uv,
                                      kp_valid, radius=radius)
    ok = match >= 0
    slot = jnp.maximum(match, 0)
    return (uvp, vis, jnp.where(vis, ids, -1), match, dist, ok, slot,
            kp_uv[slot], kp_depth[slot], jnp.sum(ok.astype(jnp.int32)))


def _frame(uv, desc, valid, depth):
    t = torch.from_numpy
    return FrameObs(*([None] * len(FrameObs._fields)))._replace(
        uv=t(uv), desc=t(desc), valid=t(valid), depth=t(depth))


def _seeded(seed=0):
    """``selfcheck.track_pass_inputs`` at the test's size, as numpy."""
    pt_pos, pt_desc, ids, T, cam, wh, fr = selfcheck.track_pass_inputs(
        "cpu", n=512, F=256, n_pts=2048, seed=seed)
    return dict(pt_pos=pt_pos.numpy(), pt_desc=pt_desc.numpy(),
                ids=ids.numpy(), T=T.numpy(), cam=cam.numpy(), img_wh=wh,
                uv=fr.uv.numpy(), desc=fr.desc.numpy(),
                valid=fr.valid.numpy(), depth=fr.depth.numpy())


def _edge_case():
    """Identity pose, fx = fy = 1, every point at depth 1: the predicted
    pixel is the point's (x, y) exactly in both packages.  Each query has
    keypoints on its window's edge (inside), one float32 ulp past it
    (outside, at a lower distance, so that taking it changes the match),
    Hamming ties at distance 0 and 3, second-best duplicates, and three
    queries claiming one target (two at the lower distance)."""
    rng = np.random.default_rng(7)
    n, F, r = 24, 96, np.float32(15.0)
    qd = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    q_uv = np.stack([np.arange(n) * 25.0 + 40.0,
                     np.full(n, 200.0)], 1).astype(np.float32)
    kp_uv = rng.uniform((0, 300), (640, 480), (F, 2)).astype(np.float32)
    kp_desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)

    def flip(d, bits):
        d = d.copy()
        for b in range(bits):
            d[b // 8] ^= np.uint8(1 << (b % 8))
        return d

    k = 0
    for q in range(0, 12):  # edges along +u, -u, +v, -v
        axis, sgn = [(0, 1), (0, -1), (1, 1), (1, -1)][q % 4]
        edge = q_uv[q].copy()
        edge[axis] = edge[axis] + sgn * r
        past = edge.copy()
        past[axis] = np.nextafter(edge[axis], np.float32(sgn * np.inf))
        inside = edge.copy()
        inside[axis] = np.nextafter(edge[axis], np.float32(-sgn * np.inf))
        kp_uv[k], kp_desc[k] = edge, flip(qd[q], 5)
        kp_uv[k + 1], kp_desc[k + 1] = past, flip(qd[q], 1)
        kp_uv[k + 2], kp_desc[k + 2] = inside, flip(qd[q], 12)
        k += 3
    # ties: two keypoints at distance 0 (lower index wins), two at 3
    # (the ratio test rejects), best 2 with two seconds at 3 (accepted)
    for q, bits in ((12, (0, 0)), (13, (3, 3)), (14, (2, 3, 3))):
        for j, b in enumerate(bits):
            kp_uv[k] = q_uv[q] + [j + 1.0, 0.5]
            kp_desc[k] = flip(qd[q], b)
            k += 1
    # three queries on one target: distances 4, 4, 6
    for q, b in zip((15, 16, 17), (4, 4, 6)):
        q_uv[q] = q_uv[15]
        qd[q] = flip(kp_desc[k], b)
    kp_uv[k] = q_uv[15] + [1.0, 1.0]
    k += 1
    pt_pos = np.concatenate([q_uv, np.ones((n, 1), np.float32)], 1)
    ids = np.arange(n, dtype=np.int32)
    ids[-3:] = -1  # a -1-padded tail
    return dict(pt_pos=pt_pos.astype(np.float32), pt_desc=qd, ids=ids,
                T=np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                cam=np.array([1, 1, 0, 0], np.float32), img_wh=(640, 480),
                uv=kp_uv, desc=kp_desc, valid=np.ones(F, bool),
                depth=rng.uniform(0.5, 5.0, F).astype(np.float32))


def _invalid_case():
    """No valid point (every id -1) against keypoints none of which is
    valid, beside valid points against no valid keypoint."""
    c = _seeded(3)
    c["ids"] = np.full_like(c["ids"], -1)
    c["valid"] = np.zeros_like(c["valid"])
    return c


def _offgrid_case():
    """Valid keypoints outside the image (negative, past the edge, far
    off), and no image gate, so queries off the image match them: the
    grid's clamped edge cells must still hold every in-window pair."""
    c = _seeded(5)
    c["uv"][:20] = np.array([[-3.0, 10.0], [650.0, 200.0], [-100.0, -50.0],
                             [700.0, 900.0], [1e6, 3.0]] * 4, np.float32)
    c["uv"][20:40] = c["uv"][:20] + 2.0
    c["img_wh"] = None
    return c


CASES = {"seeded": _seeded, "edge": _edge_case, "invalid": _invalid_case,
         "offgrid": _offgrid_case}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def _port(c, radius):
    t = torch.from_numpy
    return pmatch.track_pass(t(c["pt_pos"]), t(c["pt_desc"]), t(c["ids"]),
                             t(c["T"]), t(c["cam"]), c["img_wh"], radius,
                             _frame(c["uv"], c["desc"], c["valid"],
                                    c["depth"]))


def _ref(c, radius, dtype=np.float32):
    f = lambda x: jnp.asarray(x.astype(dtype))  # noqa: E731
    return ref_pass(f(c["pt_pos"]), jnp.asarray(c["pt_desc"]),
                    jnp.asarray(c["ids"]), f(c["T"]), f(c["cam"]),
                    f(c["uv"]), jnp.asarray(c["desc"]),
                    jnp.asarray(c["valid"]), f(c["depth"]),
                    radius=jnp.float32(radius), img_wh=c["img_wh"])


@pytest.mark.parametrize("radius", selfcheck.TRACK_RADII)
@pytest.mark.parametrize("name", list(CASES))
def test_twin_against_reference(name, radius):
    c = _case(name)
    port = _port(c, radius)
    ref = _ref(c, radius)
    for f, r in zip(FIELDS, ref):
        p = getattr(port, f).numpy()
        if f == "uv_pred":
            # float64 reference: the float32 projection's rounding
            r64 = np.asarray(_ref(c, radius, np.float64)[0])
            fin = np.isfinite(r64).all(1) & (np.abs(r64) < 1e4).all(1)
            np.testing.assert_allclose(p[fin], r64[fin], rtol=0, atol=1e-4)
        elif f in ("uv_m", "depth_m"):
            np.testing.assert_array_equal(p, np.asarray(r))
        else:
            np.testing.assert_array_equal(p, np.asarray(r), err_msg=f)
    if name == "edge" and radius == 15.0:
        m = port.match.numpy()
        assert (m[:12] == np.arange(12) * 3).all()  # the edge, not past it
        assert m[12] == 36 and m[13] == -1 and m[14] == 40
        assert m[15] == m[16] == 43 and m[17] == -1
        assert (port.vis_pt.numpy()[-3:] == -1).all()
    if name == "invalid":
        assert not port.ok.any() and int(port.n_match) == 0
    if name == "seeded":
        assert int(port.n_match) > 20


def _cell(x, inv, n):
    t = np.float32(np.float32(x) * inv)
    t = np.float32(0.0) if np.isnan(t) else min(max(t, np.float32(0.0)),
                                                np.float32(n - 1))
    return int(np.floor(t))


def pass_by_plan(c, radius, twin, seed=0):
    """csrc/track_pass.cu's match, step by step on numpy: the keypoints
    counting-sorted by cell (shuffled within a cell: the order there must
    not matter), each query's bounding box clamped into the grid, each
    grid row's run of sorted keypoints, the window test in float32, the
    best two by (distance, index), the ratio gate, the claims.  The
    queries' pixels and visibility are the twin's (the kernel's are
    bitwise equal on the card).  Returns (match, dist, pairs scanned)."""
    uv, vis = twin.uv_pred.numpy(), twin.vis.numpy()
    n, F = len(uv), len(c["uv"])
    p = pmatch.track_pass_plan(n, F, radius, c["img_wh"])
    inv = np.float32(1.0 / np.float32(p.cell))
    kcell = np.array([_cell(c["uv"][b, 1], inv, p.gy) * p.gx
                      + _cell(c["uv"][b, 0], inv, p.gx) if c["valid"][b]
                      else -1 for b in range(F)])
    rng = np.random.default_rng(seed)
    order = [b for cc in range(p.gx * p.gy)
             for b in rng.permutation(np.flatnonzero(kcell == cc))]
    start = np.concatenate([[0], np.cumsum(np.bincount(
        kcell[kcell >= 0], minlength=p.gx * p.gy))])
    safe = np.maximum(c["ids"], 0)
    ham = np.unpackbits(c["pt_desc"][safe][:, None, :]
                        ^ c["desc"][None, :, :], axis=2).sum(2)
    r2 = np.float32(radius * radius)
    rr = np.float32(radius + pmatch.TRACK_MARGIN)
    ratio = np.float32(0.9)
    match = np.full(n, -1)
    dist = np.full(n, BIG)
    scanned = 0
    for q in range(n):
        best, second, best_i = BIG, BIG, 0
        if vis[q]:
            u, v = uv[q]
            lx, hx = _cell(u - rr, inv, p.gx), _cell(u + rr, inv, p.gx)
            ly, hy = _cell(v - rr, inv, p.gy), _cell(v + rr, inv, p.gy)
            for gy in range(ly, hy + 1):
                for pos in range(start[gy * p.gx + lx],
                                 start[gy * p.gx + hx + 1]):
                    b = order[pos]
                    scanned += 1
                    du = np.float32(u - c["uv"][b, 0])
                    dv = np.float32(v - c["uv"][b, 1])
                    if not np.float32(du * du + dv * dv) <= r2:
                        continue
                    d = int(ham[q, b])
                    if d < best or (d == best and b < best_i):
                        best, second, best_i = d, best, b
                    elif d < second:
                        second = d
        if best <= pmatch.TH_HIGH and \
                np.float32(best) <= np.float32(ratio * np.float32(second)):
            match[q] = best_i
        dist[q] = best
    claim = np.full(F, BIG)
    for q in np.flatnonzero(match >= 0):
        claim[match[q]] = min(claim[match[q]], dist[q])
    ok = (match >= 0) & (dist <= claim[np.maximum(match, 0)])
    return np.where(ok, match, -1), np.where(ok, dist, BIG), scanned


@pytest.mark.parametrize("radius", selfcheck.TRACK_RADII)
@pytest.mark.parametrize("name", list(CASES))
def test_cell_plan_equals_full_scan(name, radius):
    c = _case(name)
    twin = _port(c, radius)
    match, dist, scanned = pass_by_plan(c, radius, twin, seed=int(radius))
    np.testing.assert_array_equal(match, twin.match.numpy())
    np.testing.assert_array_equal(dist, twin.dist.numpy())
    if name == "seeded" and radius < 60:
        # the cells prune: far fewer pairs than the full scan's
        assert scanned < 0.2 * twin.vis.numpy().sum() * c["valid"].sum()


@pytest.mark.parametrize("F", [1, 256, 1000, 2000])
@pytest.mark.parametrize("radius", selfcheck.TRACK_RADII + (0.5, 300.0))
def test_track_pass_plan_limits(radius, F):
    for n, wh in ((1, (640, 480)), (512, (640, 480)), (4096, (640, 480)),
                  (5000, None), (4096, (320, 240))):
        p = pmatch.track_pass_plan(n, F, radius, wh)
        w, h = wh or pmatch.TRACK_EXTENT
        assert 1 <= p.cluster <= 8 and p.cluster * p.chunk >= n
        assert p.gx * p.gy <= pmatch.TRACK_MAX_CELLS
        assert p.gx * p.cell >= w and p.gy * p.cell >= h
        assert p.cell >= min(radius, max(w, h)) or radius < 1.0
        assert p.smem <= H100_SMEM and p.smem % 16 == 0
    with pytest.raises(ValueError):
        pmatch.track_pass_plan(4096, 5000, 15.0, (640, 480))


def solve_dense(A, b):
    """lie.cuh::solve_dense on numpy float64: the first largest pivot, rows
    swapped, then back substitution."""
    A, b = A.copy(), b.copy()
    N = len(b)
    for c in range(N):
        p = c
        for r in range(c + 1, N):
            if abs(A[r, c]) > abs(A[p, c]):
                p = r
        if p != c:
            A[[c, p]] = A[[p, c]]
            b[[c, p]] = b[[p, c]]
        for r in range(c + 1, N):
            f = A[r, c] / A[c, c]
            for k in range(c, N):
                A[r, k] -= f * A[c, k]
            b[r] -= f * b[c]
    x = np.zeros(N)
    for c in range(N - 1, -1, -1):
        s = b[c]
        for k in range(c + 1, N):
            s -= A[c, k] * x[k]
        x[c] = s / A[c, c]
    return x


def warp_eliminate(A, b):
    """csrc/vi_pose.cu::eliminate by a plain loop: lane r keeps row r and
    its position pos[r]; each column's pivot is the largest |A[r, c]| over
    the lanes at positions >= c, the lowest position on a tie (a NaN on
    the diagonal keeps its row, one below it is never taken); positions c
    and p exchange; the lanes past c eliminate against the pivot lane's
    row; back substitution reads each position's lane."""
    A, b = A.copy(), b.copy()
    N = len(b)
    pos = np.arange(N)
    piv = np.zeros(N, int)
    for c in range(N):
        key = []
        for r in range(N):
            v = abs(A[r, c])
            if pos[r] < c or (np.isnan(v) and pos[r] != c):
                v = -1.0
            key.append((np.inf if np.isnan(v) else v, -pos[r]))
        p = pos[max(range(N), key=lambda r: key[r])]
        pos = np.where(pos == p, c, np.where(pos == c, p, pos))
        src = int(np.flatnonzero(pos == c)[0])
        piv[c] = src
        for r in range(N):
            if pos[r] > c:
                f = A[r, c] / A[src, c]
                for k in range(c, N):
                    A[r, k] -= f * A[src, k]
                b[r] -= f * b[src]
    x = np.zeros(N)
    for c in range(N - 1, -1, -1):
        r = piv[c]
        s = b[r]
        for k in range(c + 1, N):
            s -= A[r, k] * x[k]
        x[c] = s / A[r, c]
    return x


@pytest.mark.parametrize("seed", range(6))
def test_k20_warp_elimination(seed):
    sys_ = selfcheck.lm_solve_system(15, seed=seed)
    H, g = sys_["H"] + 1e-6 * np.eye(15), -sys_["g"]
    if seed == 5:
        # a column of ties: the first largest pivot in position order
        H[:, 3] = np.where(np.arange(15) % 2, 1.0, -1.0)
    x = warp_eliminate(H, g)
    # the kernel's operations and order: bitwise solve_dense's
    np.testing.assert_array_equal(x, solve_dense(H, g))
    # against the twin's float64 solve (torch.linalg.solve_ex), within
    # K22c's tolerance: H's condition number is 3e10-2e12, and two LAPACK
    # builds' solves already part by ~4e-9 of the largest step here
    t = torch.linalg.solve_ex(torch.from_numpy(H), torch.from_numpy(g))[0]
    ref = t.numpy()
    assert np.abs(x - ref).max() <= selfcheck.LM_SOLVE_TOL * np.abs(ref).max()
    assert np.ptp(np.log10(np.abs(np.diag(H)))) > 10  # ~1e-10 .. 1e7
