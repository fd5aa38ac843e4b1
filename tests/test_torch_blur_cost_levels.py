"""Port parity of K1's blur over a whole extraction and of K22a's
back-substitution and cost.

``gaussian_blur_levels_torch`` (the plain version of the one-launch blur
over every level and frame) against the reference's ``gaussian_blur`` on
the levels of its pyramid of a (2, 240, 320) batch of ``arc`` frames, and
on levels smaller than the blur's 7 taps; the blur's launch plan (every
pixel in one tile) and a numpy model of the kernel's tiles (the staged
window with clamped coordinates, the vertical pass into a second tile, the
horizontal pass out of it) against the twin, bitwise; ``extract_orb`` on
the CPU against the composition of its per-level twins.  K22a's cost twin
on a reprojection-only problem against the reference's ``problem_cost``
at the current points and at a candidate, and the step-and-cost launch's
CTA ranges (every landmark and every plan row in one CTA).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.optim import solve as rsolve
from visual_sgraphs_tpu_torch.features import fast as pfast
from visual_sgraphs_tpu_torch.features import orb as porb
from visual_sgraphs_tpu_torch.features import pyramid as ppyr
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk

import torch_parity as tp
from test_torch_lm import BF, CAM, _port_rows, _ref_reproj_batches, reproj_case
from torch_parity import one_torch_thread  # noqa: F401

BLUR_TOL = 1e-4  # the twin against the reference (tests/test_torch_features)
COST_TOL = 1e-5  # relative: float32 residuals, sums in another order
TINY = ((1, 1), (3, 5), (6, 6), (7, 7), (9, 12), (30, 36), (40, 70))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _ref_blurred(img, n_levels, scale):
    """The reference's pyramid of one frame and each level's blur."""
    levels = rpyr.build_pyramid(img, n_levels, scale)
    return levels, [rpyr.gaussian_blur(lv) for lv in levels]


@pytest.fixture(scope="module")
def ref():
    """(levels, blurred) per level, stacked over 2 ``arc`` frames."""
    params = porb.OrbParams()
    scene = SyntheticScene(h=240, w=320)
    frames = [_ref_blurred(jnp.asarray(np.asarray(g, np.float32)),
                           params.n_levels, params.scale)
              for g, _, _, _ in scene.frames(2, kind="arc")]
    return [tuple(np.stack([np.asarray(f[i][lv]) for f in frames])
                  for i in range(2)) for lv in range(params.n_levels)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def test_blur_levels_twin_against_reference(ref):
    # every level of the batch within 1e-4 of the reference's blur of each
    # frame (on [0, 255]: the reference's taps and sums in its own order)
    # and bitwise the per-level twin; a level without a budget stays None
    levels = [_t(lv) for lv, _ in ref]
    levels[3] = None
    got = ppyr.gaussian_blur_levels(levels)
    assert got[3] is None
    for lv, g, (_, want) in zip(levels, got, ref):
        if lv is None:
            continue
        assert float(np.abs(g.numpy() - want).max()) <= BLUR_TOL
        assert _bits_equal(g, ppyr.gaussian_blur_torch(lv))


def test_blur_levels_tiny(rng):
    # levels thinner than the 3-pixel halo on a side, down to 1x1, where
    # every tap clamps to the level's edge
    levels = [rng.uniform(0, 255, (2, h, w)).astype(np.float32)
              for h, w in TINY]
    got = ppyr.gaussian_blur_levels_torch([_t(x) for x in levels])
    blur = jax.jit(jax.vmap(rpyr.gaussian_blur))
    for x, g in zip(levels, got):
        assert float(np.abs(g.numpy() - np.asarray(blur(x))).max()) \
            <= BLUR_TOL


def _tile_owner(plan, t):
    """The level of tile ``t`` as the kernel finds it: the last level
    whose first tile is <= t."""
    return max(i for i in range(len(plan) // 4) if plan[4 * i + 3] <= t)


def _tiles(plan, n_tiles):
    """(level, first row, first column) of every tile of the grid."""
    R, C = ppyr.BLUR_TILE
    for t in range(n_tiles):
        lv = _tile_owner(plan, t)
        _, _, tx, t0 = plan[4 * lv: 4 * lv + 4]
        ty, tc = divmod(t - t0, tx)
        yield lv, ty * R, tc * C


@pytest.mark.parametrize("shapes", [
    ppyr.pyramid_shapes(480, 640, 8, 1.2),
    ppyr.pyramid_shapes(240, 320, 8, 1.2),
    ppyr.pyramid_shapes(720, 1280, 8, 1.2),
    list(TINY)], ids=["480x640", "240x320", "720x1280", "tiny"])
def test_blur_tile_plan_covers_once(shapes):
    # every pixel of every level in exactly one tile of the grid, no tile
    # past its level
    plan, n_tiles = ppyr.blur_tile_plan(shapes)
    R, C = ppyr.BLUR_TILE
    cover = [np.zeros(s, np.int32) for s in shapes]
    for lv, r0, c0 in _tiles(plan, n_tiles):
        assert r0 < shapes[lv][0] and c0 < shapes[lv][1]
        cover[lv][r0:r0 + R, c0:c0 + C] += 1
    assert all((c == 1).all() for c in cover)


def _blur_model(levels):
    """csrc/pyramid.cu's blur in numpy float32, tile by tile: the 38 x 70
    window staged with clamped coordinates, the vertical taps into a
    second tile (8 rows from 14 inputs), the horizontal taps out of it,
    each product and sum rounded in the twin's order, the outputs inside
    the level written."""
    k = [np.float32(v) for v in ppyr._blur_taps(7, 2.0)]
    R, C = ppyr.BLUR_TILE
    plan, n_tiles = ppyr.blur_tile_plan([x.shape[-2:] for x in levels])
    outs = [np.full_like(x, np.nan) for x in levels]

    def taps(x, axis, n):
        acc = k[0] * x.take(np.arange(n), axis)
        for t in range(1, 7):
            acc = acc + k[t] * x.take(np.arange(t, t + n), axis)
        return acc

    for lv, r0, c0 in _tiles(plan, n_tiles):
        x = levels[lv]
        h, w = x.shape[-2:]
        rr = np.clip(np.arange(r0 - 3, r0 + R + 3), 0, h - 1)
        cc = np.clip(np.arange(c0 - 3, c0 + C + 3), 0, w - 1)
        win = x[:, rr][:, :, cc]
        tile = taps(taps(win, 1, R), 2, C)
        nr, nc = min(R, h - r0), min(C, w - c0)
        outs[lv][:, r0:r0 + nr, c0:c0 + nc] = tile[:, :nr, :nc]
    return outs


def test_blur_model_matches_twin(ref, rng):
    # the kernel's tiling and clamping against the twin, bitwise, on two
    # frames' 240x320 pyramid and on the tiny levels
    levels = [lv for lv, _ in ref] + [
        rng.uniform(0, 255, (2, h, w)).astype(np.float32) for h, w in TINY]
    for x, m in zip(levels, _blur_model(levels)):
        assert _bits_equal(_t(m), ppyr.gaussian_blur_torch(_t(x)))


def test_extract_orb_cpu_unchanged():
    # extract_orb on CPU tensors equals its per-level twins composed as
    # before the one-launch blur: the pyramid, FAST + NMS, the selection,
    # each level's blur, the descriptors
    params = porb.OrbParams(n_features=300)
    scene = SyntheticScene(h=240, w=320)
    img = _t(np.stack([np.asarray(g, np.float32)
                       for g, _, _, _ in scene.frames(2, kind="arc")]))
    got = porb.extract_orb(img, params)
    budgets = porb.level_budgets(params)
    levels = ppyr.build_pyramid_torch(img, params.n_levels, params.scale)
    live = [lv if b > 0 else None for lv, b in zip(levels, budgets)]
    kp = porb.detect_levels_torch(pfast.fast_levels_torch(live), budgets,
                                  params)
    angle, desc = porb.orb_describe_levels_torch(
        [None if lv is None else ppyr.gaussian_blur_torch(lv)
         for lv in live], kp.rc, budgets,
        porb.brief_pattern_tensor(params.pattern_seed, img.device))
    for name, want in (("uv", kp.uv), ("response", kp.response),
                       ("level", kp.level), ("valid", kp.valid),
                       ("angle", angle), ("desc", desc)):
        assert torch.equal(getattr(got, name), want), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reproj_cost_twin_against_reference(dtype):
    # K22a's cost twin on a reprojection-only window (mono and stereo
    # rows, a duplicate observation, a point behind the cameras, two fixed
    # points without rows) against the reference's problem_cost at the
    # current points and at a candidate (one damped step of the twin's
    # route, slot 0 the gauge): within 1e-5 relative
    c = reproj_case()
    jd = jnp.float32 if dtype == "float32" else jnp.float64
    td = getattr(torch, dtype)
    pts = tp.t(c["pts"]).to(td)
    rows = _port_rows(c)._replace(uvr=tp.t(c["uvr"]).to(td))
    cam, bf = tp.t(CAM).to(td), torch.tensor(BF, dtype=td)
    red = lmk.Reduced(pose=tp.t(c["poses"]).to(td))
    pt_fixed = tp.t(c["pt_fixed"])
    lam = torch.tensor(1e-3, dtype=td)
    D = lmk.offsets(red)["D"]
    H, g, pairs, rhs, st = lmk.lm_reproj_reduce_torch(red.pose, pts, rows,
                                                      cam, bf, lam, D)
    dx, cand = lmk.lm_solve_torch(H, g, pairs, rhs, lmk.free_mask(
        red, {"pose": tp.t(c["kf_fixed"])}), lam, red)
    plan = lmk.lm_reproj_plan(rows, pts.shape[0])
    _, cost0 = lmk.lm_reproj_cost(red.pose, pts, pt_fixed, rows, cam, bf,
                                  plan=plan)
    pts_c, cost_c = lmk.lm_reproj_cost(cand.pose, pts, pt_fixed, rows, cam,
                                       bf, st, dx, plan=plan)
    assert float((pts_c - pts).abs().max()) > 1e-4  # the step moved them
    assert torch.equal(pts_c[pt_fixed], pts[pt_fixed])
    with jax.enable_x64(dtype == "float64"):
        problem = rgraph.GraphProblem(
            families={"kf": rgraph.se3_family(jnp.asarray(c["poses"], jd)),
                      "pt": rgraph.point_family(jnp.asarray(c["pts"], jd))},
            factors=_ref_reproj_batches(c, jd), eliminated="pt")
        cost = jax.jit(lambda kf, pt: rsolve.problem_cost(
            problem, {"kf": kf, "pt": pt}))
        want0 = float(cost(jnp.asarray(c["poses"], jd),
                           jnp.asarray(c["pts"], jd)))
        want_c = float(cost(jnp.asarray(cand.pose.numpy()),
                            jnp.asarray(pts_c.numpy())))
    assert want_c < want0  # the candidate is a descent step
    for got, want in ((cost0, want0), (cost_c, want_c)):
        assert abs(float(got) - want) <= COST_TOL * abs(want)


@pytest.mark.parametrize("N", [0, 1, 15, 16, 17, 4096, 8193])
def test_cost_ctas_cover_landmarks_and_rows_once(rng, N):
    # the step-and-cost launch's CTAs own consecutive landmark ranges that
    # cover [0, N) once, and so the plan's rows once (no CTA past N but the
    # one CTA of an empty problem, which writes the cost)
    M = 3 * N + 7
    pt = rng.integers(-2, N + 2, M).astype(np.int32)
    use = rng.uniform(size=M) < 0.7
    rows = lmk.ReprojRows(_t(np.zeros(M, np.int32)), _t(pt),
                          _t(np.zeros((M, 3), np.float32)), _t(use),
                          _t(np.zeros(M, bool)))
    ptr, idx = (x.numpy() for x in lmk.lm_reproj_plan(rows, N))
    G, per = lmk.cost_ctas(N), lmk.COST_LANDMARKS
    assert G == max(1, -(-N // per))
    owned = np.zeros(N, np.int32)
    seen = []
    for b in range(G):
        n0, n1 = b * per, min(N, (b + 1) * per)
        assert n0 < max(N, 1)
        owned[n0:n1] += 1
        if n1 > n0:
            seen += idx[ptr[n0]:ptr[n1]].tolist()
    assert (owned == 1).all()
    want = np.flatnonzero(use & (pt >= 0) & (pt < N))
    assert sorted(seen) == want.tolist()
