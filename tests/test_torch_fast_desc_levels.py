"""Port parity of K2 and K4 over a whole extraction: ``fast_levels_torch``
(the plain version of the one-launch FAST score + NMS over every level)
and ``orb_describe_levels_torch`` (of the one-launch IC angle + steered
BRIEF over every level's keypoints) against the reference on a (3, 240,
320) batch of ``arc`` frames: the scores exactly, the angles within 1e-5
rad and the descriptors bitwise given the reference's angles; the same on
levels smaller than the 41x41 patch and than FAST's 7x7 ring; the launch
plans (every pixel and keypoint row covered once); numpy models of the
kernels' arithmetic (K2's tiles and arc extrema from pair, quad and
octet extrema, K4's staged patches, moments over the disc's runs of rows and
ballot-packed descriptor words) against the twins; and ``extract_orb`` against the
composition of the per-level twins.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.features import fast as rfast
from visual_sgraphs_tpu.features import orb as rorb
from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu_torch.features import fast as pfast
from visual_sgraphs_tpu_torch.features import orb as porb
from visual_sgraphs_tpu_torch.features import pyramid as ppyr

from torch_parity import one_torch_thread  # noqa: F401

PARAMS = rorb.OrbParams(n_features=300)
PPARAMS = porb.OrbParams(n_features=300)
BUDGETS = porb.level_budgets(PPARAMS)
PATTERN = rorb._brief_pattern(42).astype(np.float32)
ANGLE_TOL = 1e-5  # rad: atan2 of float32 moments in two libraries


@functools.partial(jax.jit, static_argnums=1)
def _ref_levels(img, params):
    """The reference's per-level pyramid, scores, keypoints, blurred
    levels, angles and descriptors of one frame."""
    pattern = jnp.asarray(rorb._brief_pattern(params.pattern_seed),
                          jnp.float32)
    out = []
    for lv, budget in zip(rpyr.build_pyramid(img, params.n_levels,
                                             params.scale),
                          rorb.level_budgets(params)):
        score = rfast.nms3x3(rfast.fast_score(lv))
        rc, _, _ = rorb._detect_level(score, budget, params)
        blurred = rpyr.gaussian_blur(lv)
        patches = rorb._gather_patches(blurred, rc, rorb.GATHER_RADIUS)
        angle = rorb._ic_angle(patches)
        out.append((lv, score, rc, blurred, angle,
                    rorb._steered_brief(patches, angle, pattern)))
    return out


@pytest.fixture(scope="module")
def ref():
    """Per level, stacked over the 3 frames: (level, score, rc, blurred,
    angle, desc) as numpy."""
    scene = SyntheticScene(h=240, w=320)
    frames = [_ref_levels(jnp.asarray(np.asarray(g, np.float32)), PARAMS)
              for g, _, _, _ in scene.frames(3, kind="arc")]
    return [tuple(np.stack([np.asarray(f[lv][i]) for f in frames])
                  for i in range(6)) for lv in range(len(BUDGETS))]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_fast_levels_twin_exact(ref):
    # exact (by value): subtraction, min and max round identically
    scores = pfast.fast_levels([_t(r[0]) for r in ref])
    for r, s in zip(ref, scores):
        np.testing.assert_array_equal(s.numpy(), r[1])
        assert (r[1] > 0).sum() > 0


TINY = ((3, 5), (6, 6), (7, 7), (7, 9), (9, 12), (30, 36))


def test_fast_levels_twin_tiny_levels(rng):
    # levels narrower than FAST's 7x7 ring score 0 everywhere; a level
    # without a budget (None) stays None
    levels = [rng.uniform(0, 255, (2, h, w)).astype(np.float32)
              for h, w in TINY]
    got = pfast.fast_levels_torch([_t(x) for x in levels] + [None])
    assert got[-1] is None
    ref = jax.jit(jax.vmap(lambda x: rfast.nms3x3(rfast.fast_score(x))))
    for x, s in zip(levels, got):
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref(x)))


def _tile_owner(plan, t):
    """The level of tile ``t`` as the kernel finds it: the last level
    whose first tile is <= t."""
    return max(i for i in range(len(plan) // 4) if plan[4 * i + 3] <= t)


@pytest.mark.parametrize("shapes", [
    ppyr.pyramid_shapes(480, 640, 8, 1.2),
    ppyr.pyramid_shapes(240, 320, 8, 1.2),
    ppyr.pyramid_shapes(720, 1280, 8, 1.2),
    list(TINY) + [(1, 1)]], ids=["480x640", "240x320", "720x1280", "tiny"])
def test_fast_tile_plan_covers_once(shapes):
    # every pixel of every level in exactly one tile of the grid
    plan, n_tiles = pfast.fast_tile_plan(shapes)
    cover = [np.zeros(s, np.int32) for s in shapes]
    for t in range(n_tiles):
        lv = _tile_owner(plan, t)
        h, w, tx, t0 = plan[4 * lv: 4 * lv + 4]
        ty, tc = divmod(t - t0, tx)
        assert ty * pfast.TILE < h
        cover[lv][ty * pfast.TILE:(ty + 1) * pfast.TILE,
                  tc * pfast.TILE:(tc + 1) * pfast.TILE] += 1
    assert all((c == 1).all() for c in cover)


RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))


def _arc_extreme(v, ext, comb):
    """csrc/fast.cu's arc_extreme: ``comb`` over the 16 cyclic 9-arcs of
    ``ext`` over the arc, arcs 2k and 2k + 1 together as ext(octet
    v[2k+1..2k+8], comb(v[2k], v[2k+9])), the octets from pair and quad
    extrema at the odd positions."""
    pair = [ext(v[2 * k + 1], v[(2 * k + 2) % 16]) for k in range(8)]
    quad = [ext(pair[k], pair[(k + 1) % 8]) for k in range(8)]
    octet = [ext(quad[k], quad[(k + 2) % 8]) for k in range(8)]
    best = ext(octet[0], comb(v[0], v[9]))
    for k in range(1, 8):
        best = comb(best, ext(octet[k], comb(v[2 * k], v[(2 * k + 9) % 16])))
    return best


def _k2_model(img, tile=32):
    """K2 on one (h, w) level as csrc/fast.cu computes it, tile by tile:
    the input staged with a 4-pixel clamped halo, the score tile with a
    1-pixel ring (-inf outside the level, 0 within 3 of its edge), the
    bright score fl(max min ring - p), the dark fl(p - min max ring), the
    NMS from row maxima of 3."""
    h, w = img.shape
    out = np.full((h, w), np.nan, np.float32)
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            rr = np.clip(np.arange(r0 - 4, r0 + tile + 4), 0, h - 1)
            cc = np.clip(np.arange(c0 - 4, c0 + tile + 4), 0, w - 1)
            x = img[rr[:, None], cc[None, :]]
            n = tile + 2
            ring = [x[3 + dr:3 + dr + n, 3 + dc:3 + dc + n] for dr, dc in RING]
            p = x[3:3 + n, 3:3 + n]
            bright = _arc_extreme(ring, np.minimum, np.maximum) - p
            dark = p - _arc_extreme(ring, np.maximum, np.minimum)
            s = np.maximum(np.maximum(bright, dark), np.float32(0))
            r = np.arange(r0 - 1, r0 + tile + 1)[:, None]
            c = np.arange(c0 - 1, c0 + tile + 1)[None, :]
            interior = (r >= 3) & (r < h - 3) & (c >= 3) & (c < w - 3)
            inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            s = np.where(inside, np.where(interior, s, np.float32(0)),
                         np.float32(-np.inf))
            hm = np.maximum(np.maximum(s[:, :-2], s[:, 1:-1]), s[:, 2:])
            m = np.maximum(np.maximum(hm[:-2], hm[1:-1]), hm[2:])
            o = np.where(s[1:-1, 1:-1] >= m, s[1:-1, 1:-1], np.float32(0))
            blk = out[r0:r0 + tile, c0:c0 + tile]
            assert np.isnan(blk).all()
            blk[...] = o[:blk.shape[0], :blk.shape[1]]
    return out


def test_fast_kernel_model(ref, rng):
    # K2's arithmetic, tile by tile, exact against the twin on the first
    # frame's levels and on the tiny levels
    levels = [r[0][0] for r in ref] + [
        rng.uniform(0, 255, s).astype(np.float32) for s in TINY]
    for x in levels:
        np.testing.assert_array_equal(
            _k2_model(x), pfast.fast_nms_torch(_t(x)).numpy())


def _concat(ref):
    """The extraction's concatenated (3, N, 2) rc, (3, N) angle and (3, N,
    32) desc, and the blurred levels (3, h, w)."""
    cat = [np.concatenate([r[i] for r in ref], axis=1) for i in (2, 4, 5)]
    return (*cat, [r[3] for r in ref])


def test_orb_describe_levels_twin(ref):
    # angle: 1e-5 rad (float32 moments, atan2 in two libraries);
    # descriptor: bitwise, given the reference's angles
    rc, r_angle, r_desc, blurred = _concat(ref)
    assert rc.shape == (3, sum(BUDGETS), 2)
    bl = [_t(b) for b in blurred]
    angle, _ = porb.orb_describe_levels(bl, _t(rc.astype(np.int32)),
                                        BUDGETS, _t(PATTERN))
    _, desc = porb.orb_describe_levels_torch(
        bl, _t(rc.astype(np.int32)), BUDGETS, _t(PATTERN),
        angle=_t(r_angle.astype(np.float32)))
    np.testing.assert_allclose(angle.numpy(), r_angle, rtol=0,
                               atol=ANGLE_TOL)
    np.testing.assert_array_equal(desc.numpy(), r_desc)


def _ref_describe(img, rc):
    """The reference's angles and descriptors of one level's keypoints."""
    patches = rorb._gather_patches(jnp.asarray(img), jnp.asarray(rc),
                                   rorb.GATHER_RADIUS)
    angle = rorb._ic_angle(patches)
    return (np.asarray(angle, np.float32), np.asarray(
        rorb._steered_brief(patches, angle, jnp.asarray(PATTERN))))


def test_orb_describe_levels_tiny_levels(rng):
    # levels smaller than the 41x41 patch (the reference edge-pads them)
    # and than FAST's ring, through the levels entry, with a level
    # without a budget between them
    shapes, budgets = [(30, 36), (40, 40), (5, 6)], [24, 0, 16]
    levels = [rng.uniform(0, 255, (2, h, w)).astype(np.float32)
              for h, w in shapes]
    rc = np.concatenate([
        np.stack([rng.integers(0, h, (2, b)), rng.integers(0, w, (2, b))],
                 -1) for (h, w), b in zip(shapes, budgets)], 1)
    rc = rc.astype(np.int32)
    angle, desc = porb.orb_describe_levels(
        [_t(x) if b else None for x, b in zip(levels, budgets)], _t(rc),
        budgets, _t(PATTERN))
    off = 0
    for x, b in zip(levels, budgets):
        for f in range(2 if b else 0):
            ra, rd = _ref_describe(x[f], rc[f, off:off + b])
            np.testing.assert_allclose(angle[f, off:off + b].numpy(), ra,
                                       rtol=0, atol=ANGLE_TOL)
            np.testing.assert_array_equal(desc[f, off:off + b].numpy(), rd)
        off += b


def _row_level(plan, n):
    """The level of keypoint row ``n`` as K4 finds it: the last level
    whose first row is <= n."""
    return max(i for i in range(len(plan) // 3) if plan[3 * i + 2] <= n)


@pytest.mark.parametrize("n_features", [300, 1000, 2000])
def test_desc_plan_rows(n_features):
    # every keypoint row of an extraction described from its own level
    budgets = porb.level_budgets(porb.OrbParams(n_features=n_features))
    shapes = ppyr.pyramid_shapes(480, 640, 8, 1.2)
    live = [i for i, b in enumerate(budgets) if b > 0]
    plan = porb.desc_plan([shapes[i] for i in live],
                          [budgets[i] for i in live])
    want = np.repeat(np.arange(len(live)), [budgets[i] for i in live])
    got = [_row_level(plan, n) for n in range(sum(budgets))]
    np.testing.assert_array_equal(got, want)
    assert all(plan[3 * i: 3 * i + 2] == list(shapes[lv])
               for i, lv in enumerate(live))


# csrc/orb_desc.cu's disc_run: the r=15 disc's rows dy as runs of equal
# half width (hw, first dy, last dy)
DISC_RUNS = ((0, -15, -15), (5, -14, -14), (7, -13, -13), (9, -12, -12),
             (10, -11, -11), (11, -10, -10), (12, -9, -8), (13, -7, -6),
             (14, -5, -1), (15, 0, 0), (14, 1, 5), (13, 6, 7), (12, 8, 9),
             (11, 10, 10), (10, 11, 11), (9, 12, 12), (7, 13, 13),
             (5, 14, 14), (0, 15, 15))


def _moment_terms(axis):
    """The terms K4 sums for m10 (axis 0) or m01, in its order: (dy, x,
    weight), row by row of the runs, x != 0 for m10, dy != 0 for m01."""
    return [(dy, x, (x, dy)[axis]) for hw, a, b in DISC_RUNS
            for dy in range(a, b + 1) for x in range(-hw, hw + 1)
            if (x, dy)[axis] != 0]


@pytest.mark.parametrize("axis", [0, 1])
def test_disc_runs_are_the_twins_terms(axis):
    # the runs read row by row are the twin's terms, in order
    terms = [(dy + 15, x + 15) for dy, x, _ in _moment_terms(axis)]
    assert terms == list(porb._ic_terms(axis)) and len(terms) == 678


def _k4_model(levels, plan, rc, angle_in=None):
    """K4 on the concatenated keypoints ``rc`` (F, N, 2) of ``levels``
    [(F, h, w)] as csrc/orb_desc.cu computes it: each row's patch from its
    level (origin clipped, reads clamped), the moments summed term by term
    in float32, row by row over the disc's runs, the 256 tests as lanes of
    8 ballots whose words are the descriptor's bytes, little-endian."""
    F, N, _ = rc.shape
    size = 41
    patches = np.empty((F, N, size * size), np.float32)
    for f in range(F):
        for n in range(N):
            h, w = plan[3 * _row_level(plan, n): 3 * _row_level(plan, n) + 2]
            img = levels[_row_level(plan, n)][f]
            r0 = min(max(rc[f, n, 0] - 20, 0), max(h, size) - size)
            c0 = min(max(rc[f, n, 1] - 20, 0), max(w, size) - size)
            rows = np.minimum(r0 + np.arange(size), h - 1)
            cols = np.minimum(c0 + np.arange(size), w - 1)
            patches[f, n] = img[rows[:, None], cols[None, :]].ravel()
    if angle_in is None:
        mom = []
        for axis in (0, 1):
            m = np.zeros((F, N), np.float32)
            for dy, x, wgt in _moment_terms(axis):
                m = m + patches[..., (20 + dy) * size + 20 + x] * np.float32(
                    wgt)
            mom.append(m)
        angle = np.arctan2(mom[1], mom[0]).astype(np.float32)
    else:
        angle = angle_in
    # cos and sin as the twin takes them (torch's float32 functions)
    ca = torch.cos(_t(angle)).numpy()[..., None]
    sa = torch.sin(_t(angle)).numpy()[..., None]
    words = np.zeros((F, N, 8), np.uint32)
    for j in range(8):
        pt = PATTERN[32 * j: 32 * j + 32]  # lane b: test 32j + b

        def sample(px, py):
            x = ca * px - sa * py
            y = sa * px + ca * py
            r = np.clip(np.rint(y) + 20, 0, 40).astype(np.int64)
            c = np.clip(np.rint(x) + 20, 0, 40).astype(np.int64)
            return np.take_along_axis(patches, r * size + c, axis=-1)

        bits = sample(pt[:, 0], pt[:, 1]) < sample(pt[:, 2], pt[:, 3])
        words[..., j] = (bits.astype(np.uint64)
                         << np.arange(32, dtype=np.uint64)).sum(-1)
    return angle, words.astype("<u4").view(np.uint8)


def test_orb_desc_kernel_model(ref):
    # K4's arithmetic against the twin: angles within 1e-5 rad,
    # descriptors bitwise given the twin's angles
    rc, _, _, blurred = _concat(ref)
    rc = rc.astype(np.int32)
    plan = porb.desc_plan([b.shape[-2:] for b in blurred], BUDGETS)
    m_angle, _ = _k4_model(blurred, plan, rc)
    t_angle, t_desc = porb.orb_describe_levels_torch(
        [_t(b) for b in blurred], _t(rc), BUDGETS, _t(PATTERN))
    np.testing.assert_allclose(m_angle, t_angle.numpy(), rtol=0,
                               atol=ANGLE_TOL)
    _, m_desc = _k4_model(blurred, plan, rc, angle_in=t_angle.numpy())
    np.testing.assert_array_equal(m_desc, t_desc.numpy())


def test_extract_orb_levels_composition(ref):
    # extract_orb on the CPU equals its per-level twins composed as the
    # extraction was before its one-launch entries
    img = _t(ref[0][0])
    kp = porb.extract_orb(img, PPARAMS)
    levels = ppyr.build_pyramid_torch(img, PPARAMS.n_levels, PPARAMS.scale)
    det = porb.detect_levels_torch(
        [pfast.fast_nms_torch(lv) for lv in levels], BUDGETS, PPARAMS)
    angle = torch.empty(det.response.shape)
    desc = torch.empty((*det.response.shape, 32), dtype=torch.uint8)
    off = 0
    pattern = porb.brief_pattern_tensor(42, torch.device("cpu"))
    for lv, b in zip(levels, BUDGETS):
        rows = slice(off, off + b)
        porb.orb_describe(ppyr.gaussian_blur_torch(lv), det.rc[..., rows, :],
                          pattern, out=(angle[..., rows], desc[..., rows, :]))
        off += b
    for name, want in (("uv", det.uv), ("response", det.response),
                       ("level", det.level), ("valid", det.valid),
                       ("angle", angle), ("desc", desc)):
        assert torch.equal(getattr(kp, name), want), name
