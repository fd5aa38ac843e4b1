"""Port parity of K3 over a whole extraction: ``detect_levels_torch`` (the
plain version of the one-launch keypoint selection over every budgeted
level) and ``extract_orb``'s selected keypoints against the reference's
``extract_orb`` on the same score pyramid, exactly: ``uv`` (float32(c) x
float32(scale ** level)), ``response``, ``level`` and ``valid``, at
240x320 with 600 and 1000 features (some levels then hold fewer
candidates than their budget) and on a tie-heavy quantised score
pyramid.  The port is fed the reference's pyramid levels: the two
packages' resizes round 2-3 ulp apart (ROADMAP.md queue 3).
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
from visual_sgraphs_tpu_torch.features import orb as porb

from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("uv", "response", "level", "valid")
N_FEATURES = (600, 1000)


@pytest.fixture(scope="module")
def grays():
    scene = SyntheticScene(h=240, w=320)
    return [np.asarray(g, np.float32)
            for g, _, _, _ in scene.frames(2, kind="arc")]


@functools.partial(jax.jit, static_argnums=1)
def _ref_extract(img, params):
    """The reference's pyramid, per-level scores and extraction."""
    levels = rpyr.build_pyramid(img, params.n_levels, params.scale)
    scores = [rfast.nms3x3(rfast.fast_score(lv)) for lv in levels]
    return levels, scores, rorb.extract_orb(img, params)


@functools.partial(jax.jit, static_argnums=1)
def _ref_select(scores, params):
    """The reference's selection and assembly (extract_orb's uv, response,
    level, valid) on given score images."""
    out = {f: [] for f in FIELDS}
    for lv, (score, budget) in enumerate(zip(scores,
                                             rorb.level_budgets(params))):
        if budget <= 0:
            continue
        rc, resp, valid = rorb._detect_level(score, budget, params)
        out["uv"].append(jnp.stack([rc[:, 1].astype(jnp.float32),
                                    rc[:, 0].astype(jnp.float32)], axis=-1)
                         * params.scale**lv)
        out["response"].append(resp)
        out["level"].append(jnp.full((budget,), lv, jnp.int32))
        out["valid"].append(valid)
    return {f: jnp.concatenate(v) for f, v in out.items()}


@functools.lru_cache(maxsize=None)
def _ref_run(key):
    """(levels, scores, keypoints) of the reference on the frames of
    ``key`` = (frame index, n_features), as numpy."""
    frame, n = key
    scene = SyntheticScene(h=240, w=320)
    gray = [np.asarray(g, np.float32)
            for g, _, _, _ in scene.frames(2, kind="arc")][frame]
    levels, scores, kp = _ref_extract(jnp.asarray(gray),
                                      rorb.OrbParams(n_features=n))
    return ([np.asarray(x) for x in levels], [np.asarray(x) for x in scores],
            {f: np.asarray(getattr(kp, f)) for f in FIELDS})


def _assert_fields(port, ref: dict, lead=()):
    for f in FIELDS:
        p = getattr(port, f).numpy()
        assert p.shape == lead + ref[f].shape, f
        np.testing.assert_array_equal(p, np.broadcast_to(ref[f], p.shape),
                                      err_msg=f)


@pytest.mark.parametrize("n", N_FEATURES)
def test_detect_levels_twin_matches_reference_extraction(n):
    _, scores, kp = _ref_run((0, n))
    params = porb.OrbParams(n_features=n)
    budgets = porb.level_budgets(params)
    out = porb.detect_levels_torch([torch.from_numpy(s) for s in scores],
                                   budgets, params)
    _assert_fields(out, kp)
    # the deepest levels hold fewer candidates than their budget
    short = [2 * (-(-s.shape[0] // 32)) * (-(-s.shape[1] // 32)) < b
             for s, b in zip(scores, budgets)]
    assert any(short) and out.valid.any() and (~out.valid).any()


@pytest.mark.parametrize("n", N_FEATURES)
def test_detect_levels_twin_batched(n):
    # a (2, H, W) batch: each frame's rows equal its extraction alone
    runs = [_ref_run((i, n)) for i in range(2)]
    params = porb.OrbParams(n_features=n)
    scores = [torch.from_numpy(np.stack([r[1][lv] for r in runs]))
              for lv in range(params.n_levels)]
    out = porb.detect_levels_torch(scores, porb.level_budgets(params),
                                   params)
    for b, (_, _, kp) in enumerate(runs):
        _assert_fields(porb.LevelKeypoints(*(x[b] for x in out)), kp)


@pytest.mark.parametrize("n", N_FEATURES)
def test_extract_orb_keypoints_match_reference(n, monkeypatch):
    # the port's whole extraction on the reference's pyramid: the selected
    # keypoints exactly, the angles within 1e-5 rad (float32 moments)
    levels, _, kp = _ref_run((0, n))
    monkeypatch.setattr(porb, "build_pyramid", lambda img, nl, s: [
        torch.from_numpy(lv) for lv in levels])
    scene = SyntheticScene(h=240, w=320)
    gray = next(scene.frames(1, kind="arc"))[0]
    out = porb.extract_orb(torch.from_numpy(np.asarray(gray, np.float32)),
                           porb.OrbParams(n_features=n))
    _assert_fields(out, kp)
    assert out.angle.shape == (n,) and out.desc.shape == (n, 32)


@pytest.mark.parametrize("n", N_FEATURES)
@pytest.mark.parametrize("step", [4.0, 16.0])
def test_detect_levels_twin_ties(n, step):
    # scores quantised to multiples of ``step``: many cells and candidates
    # tie, and lax.top_k's lower-index-first order decides
    _, scores, _ = _ref_run((0, n))
    q = [np.floor(s / np.float32(step)) * np.float32(step) for s in scores]
    ref = {f: np.asarray(v) for f, v in _ref_select(
        [jnp.asarray(s) for s in q], rorb.OrbParams(n_features=n)).items()}
    params = porb.OrbParams(n_features=n)
    out = porb.detect_levels_torch([torch.from_numpy(s) for s in q],
                                   porb.level_budgets(params), params)
    _assert_fields(out, ref)
    resp = out.response.numpy()
    assert len(np.unique(resp[resp > 0])) < 0.2 * (resp > 0).sum()
