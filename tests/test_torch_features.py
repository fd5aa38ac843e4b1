"""Port parity of the ORB front end: pyramid (K1), FAST + NMS (K2 twin),
cell top-K (K3), IC angle + steered BRIEF (K4 twin), window matcher (K5
twin) and the whole extraction chain, on the reference's own images.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.features import fast as rfast
from visual_sgraphs_tpu.features import match as rmatch
from visual_sgraphs_tpu.features import orb as rorb
from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu.io.synthetic import SyntheticScene
from visual_sgraphs_tpu_torch.features import fast as pfast
from visual_sgraphs_tpu_torch.features import match as pmatch
from visual_sgraphs_tpu_torch.features import orb as porb
from visual_sgraphs_tpu_torch.features import pyramid as ppyr

PARAMS = rorb.OrbParams(n_features=300)
PPARAMS = porb.OrbParams(n_features=300)

from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def gray():
    scene = SyntheticScene(h=240, w=320)
    g, _, _, _ = next(scene.frames(1, kind="arc"))
    return np.asarray(g, np.float32)


@functools.partial(jax.jit, static_argnums=1)
def _ref_extract(img, params):
    """The reference extractor and its per-level intermediates, compiled
    once: (levels, [(score, rc, resp, valid, blurred, angle)], keypoints)."""
    levels = rpyr.build_pyramid(img, params.n_levels, params.scale)
    per_level = []
    for lv, budget in zip(levels, rorb.level_budgets(params)):
        score = rfast.nms3x3(rfast.fast_score(lv))
        rc, resp, valid = rorb._detect_level(score, budget, params)
        blurred = rpyr.gaussian_blur(lv)
        patches = rorb._gather_patches(blurred, rc, rorb.GATHER_RADIUS)
        angle = rorb._ic_angle(patches)
        pattern = jnp.asarray(rorb._brief_pattern(params.pattern_seed),
                              jnp.float32)
        per_level.append((score, rc, resp, valid, blurred, angle,
                          rorb._steered_brief(patches, angle, pattern)))
    return levels, per_level, rorb.extract_orb(img, params)


@pytest.fixture(scope="module")
def ref_run(gray):
    levels, per_level, kp = _ref_extract(jnp.asarray(gray), PARAMS)
    return ([np.asarray(x, np.float32) for x in levels],
            [tuple(np.asarray(x) for x in out) for out in per_level], kp)


@pytest.fixture(scope="module")
def ref_levels(ref_run):
    return ref_run[0]


@pytest.fixture(scope="module")
def ref_outputs(ref_run):
    """Per level: (score, rc, resp, valid, blurred, angle, desc)."""
    return ref_run[1]


def test_pyramid_levels_match(gray, ref_levels):
    # 1e-4 abs on [0, 255] intensities: the resize weights are the same
    # float64-derived float32 matrices; only the sum order differs
    port = ppyr.build_pyramid(torch.from_numpy(gray), 8, 1.2)
    assert [tuple(p.shape) for p in port] == [r.shape for r in ref_levels]
    for r, p in zip(ref_levels, port):
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=1e-4)


def test_gaussian_blur_matches(ref_levels, ref_outputs):
    # 1e-4 abs: 14 float32 multiply-adds per pixel in either order
    for lv, out in zip(ref_levels, ref_outputs):
        p = ppyr.gaussian_blur(torch.from_numpy(lv)).numpy()
        np.testing.assert_allclose(p, out[4], rtol=0, atol=1e-4)


def test_fast_nms_twin_exact(ref_levels, ref_outputs):
    # exact: subtraction, min and max round identically everywhere
    for lv, out in zip(ref_levels, ref_outputs):
        p = pfast.fast_nms(torch.from_numpy(lv)).numpy()
        np.testing.assert_array_equal(p, out[0])
        assert (p > 0).sum() > 0


def test_detect_level_exact(ref_outputs):
    # exact: integer positions and copied scores, lax.top_k tie order
    budgets = rorb.level_budgets(PARAMS)
    assert budgets == porb.level_budgets(PPARAMS)
    for out, budget in zip(ref_outputs, budgets):
        p = porb.detect_level(torch.from_numpy(out[0]), budget, PPARAMS)
        for port, ref in zip(p, out[1:4]):
            np.testing.assert_array_equal(port.numpy(), ref)


def test_detect_level_ties_lower_index_first():
    score = np.zeros((64, 64), np.float32)
    score[5, 5] = score[5, 9] = score[40, 3] = score[40, 40] = 30.0
    score[20, 20] = 12.0
    r = rorb._detect_level(jnp.asarray(score), 4, PARAMS)
    p = porb.detect_level(torch.from_numpy(score), 4, PPARAMS)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _port_describe(img, rc, r_angle):
    """Port twin: (own angle, descriptor given the reference's angle)."""
    pattern = torch.from_numpy(rorb._brief_pattern(42).astype(np.float32))
    p_angle, _ = porb.orb_describe(torch.from_numpy(img),
                                   torch.from_numpy(rc), pattern)
    _, p_desc = porb.orb_describe(torch.from_numpy(img), torch.from_numpy(rc),
                                  pattern, angle=torch.from_numpy(r_angle))
    return p_angle.numpy(), p_desc.numpy()


def test_orb_describe_twin(ref_outputs):
    # angle: 1e-5 rad (the moments are float32 sums); descriptor: bitwise,
    # given the reference's angle
    for out in ref_outputs:
        p_angle, p_desc = _port_describe(out[4], out[1].astype(np.int32),
                                         out[5].astype(np.float32))
        np.testing.assert_allclose(p_angle, out[5], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(p_desc, out[6])


def test_orb_describe_twin_tiny_level(rng):
    # a level smaller than the 41x41 patch: the reference edge-pads it
    img = rng.uniform(0, 255, size=(30, 36)).astype(np.float32)
    rc = np.stack([rng.integers(0, 30, 40), rng.integers(0, 36, 40)],
                  -1).astype(np.int32)
    pattern = rorb._brief_pattern(42).astype(np.float32)
    patches = rorb._gather_patches(jnp.asarray(img), jnp.asarray(rc), 20)
    r_angle = np.asarray(rorb._ic_angle(patches), np.float32)
    r_desc = np.asarray(rorb._steered_brief(patches, jnp.asarray(r_angle),
                                            jnp.asarray(pattern)))
    p_angle, p_desc = _port_describe(img, rc, r_angle)
    np.testing.assert_allclose(p_angle, r_angle, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(p_desc, r_desc)


def _match_case(rng, na=512, nb=300):
    desc_b = rng.integers(0, 256, size=(nb, 32), dtype=np.uint8)
    uv_b = rng.uniform(0, 120, size=(nb, 2)).astype(np.float32)
    src = rng.integers(0, nb, size=na)
    desc_a = desc_b[src].copy()
    flips = rng.integers(0, 256, size=(na, 32)) < 6  # a few bit flips
    desc_a ^= (flips * rng.integers(1, 256, size=(na, 32))).astype(np.uint8)
    uv_a = (uv_b[src] + rng.normal(size=(na, 2)) * 3).astype(np.float32)
    # planted ties: b-twins with identical descriptors (lower index wins)
    desc_b[1] = desc_b[0]
    uv_b[1] = uv_b[0] + 1.0
    desc_a[:4] = desc_b[0]
    uv_a[:4] = uv_b[0]
    # duplicate claimants of one target at equal and unequal distances
    desc_a[4:8] = desc_b[10]
    desc_a[6, 0] ^= 1
    uv_a[4:8] = uv_b[10]
    valid_a = rng.uniform(size=na) > 0.1
    valid_b = rng.uniform(size=nb) > 0.1
    valid_b[[0, 1, 10]] = True
    valid_a[:8] = True
    lv_a = rng.integers(0, 8, size=na).astype(np.int32)
    lv_b = rng.integers(0, 8, size=nb).astype(np.int32)
    return desc_a, uv_a, valid_a, desc_b, uv_b, valid_b, lv_a, lv_b


@pytest.mark.parametrize("levels", [False, True])
def test_match_window_twin_exact(rng, levels):
    # exact: integer outputs; Hamming distances are exact in both
    a, ua, va, b, ub, vb, la, lb = _match_case(rng)
    kw_r = dict(radius=15.0)
    kw_p = dict(radius=15.0)
    if levels:
        kw_r.update(level_a=jnp.asarray(la), level_b=jnp.asarray(lb))
        kw_p.update(level_a=torch.from_numpy(la), level_b=torch.from_numpy(lb))
    rm, rd = rmatch.match_window(jnp.asarray(a), jnp.asarray(ua),
                                 jnp.asarray(va), jnp.asarray(b),
                                 jnp.asarray(ub), jnp.asarray(vb), **kw_r)
    pm, pd = pmatch.match_window(
        torch.from_numpy(a), torch.from_numpy(ua), torch.from_numpy(va),
        torch.from_numpy(b), torch.from_numpy(ub), torch.from_numpy(vb),
        **kw_p)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (pm.numpy() >= 0).sum() > 100
    if not levels:
        assert pm[0] == 0  # the tie went to the lower index
        assert (pm.numpy()[4:8] == 10).sum() >= 1


def test_hamming_matrix_exact(rng):
    a = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(48, 32), dtype=np.uint8)
    r = np.asarray(rmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    p = pmatch.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(p.numpy(), r)


def test_extract_orb_chain(gray, ref_run):
    # >= 99% of the valid keypoint set agrees: the pyramid levels differ
    # in the last float bits, which can flip a near-tie in FAST/top-K
    r = ref_run[2]
    p = porb.extract_orb(torch.from_numpy(gray), PPARAMS)

    def kp_set(uv, level, valid):
        uv, level, valid = (np.asarray(x) for x in (uv, level, valid))
        return {(round(float(u), 3), round(float(v), 3), int(lv))
                for (u, v), lv, ok in zip(uv, level, valid) if ok}

    rs = kp_set(r.uv, r.level, r.valid)
    ps = kp_set(p.uv.numpy(), p.level.numpy(), p.valid.numpy())
    assert len(rs) > 250
    assert len(rs & ps) >= 0.99 * max(len(rs), len(ps))
    same = np.all(np.asarray(r.uv) == p.uv.numpy(), axis=1)
    np.testing.assert_array_equal(p.desc.numpy()[same],
                                  np.asarray(r.desc)[same])


def test_batch_extraction_equals_per_frame():
    # a (B, H, W) batch through the ORB front end (K1-K4 once per level for
    # the batch) gives each frame exactly its own extraction
    from visual_sgraphs_tpu_torch.slam.frame import make_frame_obs
    from visual_sgraphs_tpu_torch import config as pcfg
    scene = SyntheticScene(h=120, w=160)
    frames = [(np.asarray(g, np.float32), np.asarray(d, np.float32), ts)
              for g, d, _, ts in scene.frames(24, kind="arc")][::8]
    cam = pcfg.CameraConfig(**{f: getattr(scene.cam, f) for f in (
        "fx", "fy", "cx", "cy", "width", "height")})
    orb = pcfg.OrbConfig(n_features=200)
    grays = torch.from_numpy(np.stack([g for g, _, _ in frames]))
    depths = torch.from_numpy(np.stack([d for _, d, _ in frames]))
    batch = make_frame_obs(grays, depths, [ts for _, _, ts in frames], cam,
                           orb)
    for i, (g, d, ts) in enumerate(frames):
        one = make_frame_obs(torch.from_numpy(g), torch.from_numpy(d), ts,
                             cam, orb)
        for f, a, b in zip(one._fields, batch, one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy(),
                                          err_msg=f)
        assert one.valid.sum() > 50
