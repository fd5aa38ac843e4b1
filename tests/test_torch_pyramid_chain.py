"""K1's resize chain: the packed band table that ``csrc/pyramid.cu`` reads
(``pyramid.pyramid_table``), applied level by level by a plain loop here,
against the twin's chain and the reference's ``build_pyramid``.

The kernel applies the same table to the same rounding on the card; the
card-only tests (``tests/test_torch_gpu.py``) hold it to the twin there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.features import pyramid as rpyr
from visual_sgraphs_tpu_torch.features import pyramid as ppyr

from torch_parity import one_torch_thread  # noqa: F401

SIZES = [(480, 640), (240, 320)]


def _image(h: int, w: int) -> np.ndarray:
    """A seeded gray image on [0, 255]: smooth shading plus texture."""
    rng = np.random.default_rng(h + w)
    yy, xx = np.mgrid[0:h, 0:w]
    shade = 127.5 + 100.0 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    return np.clip(shade + rng.normal(0.0, 20.0, (h, w)), 0.0,
                   255.0).astype(np.float32)


def _taps(x: np.ndarray, first: np.ndarray, wts: np.ndarray) -> np.ndarray:
    """Each output row of ``x`` (n_in, m) as the kernel sums it: the first
    tap a float32 product, each next one fused multiply-add (exact
    product, one rounding of the sum, emulated in float64)."""
    n_in = x.shape[0]
    x64 = x.astype(np.float64)
    out = np.empty((len(first), x.shape[1]), np.float32)
    for o, f in enumerate(first):
        acc = np.float32(wts[o, 0]) * x[f]
        for t in range(1, wts.shape[1]):
            row = x64[min(f + t, n_in - 1)]
            acc = (np.float64(wts[o, t]) * row + acc).astype(np.float32)
        out[o] = acc
    return out


def table_chain(img: np.ndarray, n_levels: int = 8,
                scale: float = 1.2) -> list[np.ndarray]:
    """The pyramid from the packed table alone: per level, its rows'
    band, then its columns'."""
    words, meta, _ = ppyr.pyramid_table(*img.shape, n_levels, scale)
    bits = words.view(np.float32)
    levels = [img]
    for hi, wi, ho, wo, rf, rw, rT, cf, cw, cT in meta:
        src = levels[-1]
        assert src.shape == (hi, wi)
        mid = _taps(src, words[rf:rf + ho],
                    bits[rw:rw + ho * rT].reshape(ho, rT))
        out = _taps(mid.T, words[cf:cf + wo],
                    bits[cw:cw + wo * cT].reshape(wo, cT)).T
        levels.append(np.ascontiguousarray(out))
    return levels


@functools.partial(jax.jit, static_argnums=(1, 2))
def _ref_pyramid(img, n_levels, scale):
    return rpyr.build_pyramid(img, n_levels, scale)


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def chain(request):
    img = _image(*request.param)
    return img, table_chain(img)


def test_table_chain_equals_twin_bitwise(chain):
    # the table the kernel reads, applied by the kernel's arithmetic, is
    # the twin's chain to the last bit: the same bands, offsets, taps and
    # clamped indices at every level
    img, levels = chain
    twin = ppyr.build_pyramid_torch(torch.from_numpy(img), 8, 1.2)
    assert len(levels) == len(twin) == 8
    for t, p in zip(levels, twin):
        assert t.shape == tuple(p.shape)
        np.testing.assert_array_equal(t, p.numpy())


def test_table_chain_matches_reference(chain):
    # 1e-4 abs on [0, 255], as tests/test_torch_features.py holds the
    # twin: the same float64-derived float32 weights, summed in another
    # order by the reference's dense matrix products
    img, levels = chain
    ref = _ref_pyramid(jnp.asarray(img), 8, 1.2)
    for t, r in zip(levels, ref):
        np.testing.assert_allclose(t, np.asarray(r, np.float32), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_table_windows_fit_the_kernel(size):
    # every output tile's input window lies inside the largest window the
    # table reports (the kernel's shared tiles are sized by it), and each
    # band's first index never decreases (the window runs from the tile's
    # first output's first index)
    words, meta, (win_r, win_c) = ppyr.pyramid_table(*size, 8, 1.2)
    tile_r, tile_c = ppyr.CHAIN_TILE
    for hi, wi, ho, wo, rf, _, rT, cf, _, cT in meta:
        for n_in, n_out, off, T, tile, win in (
                (hi, ho, rf, rT, tile_r, win_r), (wi, wo, cf, cT, tile_c,
                                                  win_c)):
            first = words[off:off + n_out]
            assert (np.diff(first) >= 0).all()
            for o0 in range(0, n_out, tile):
                o1 = min(o0 + tile, n_out) - 1
                assert min(first[o1] + T - 1, n_in - 1) - first[o0] < win
    # four tile groups, each two stages of window and bands and a rows
    # pass tile, fit in one block's shared memory (csrc/pyramid.cu)
    taps = int(meta[:, [6, 9]].max())
    stride = win_c | 1
    stage = win_r * stride + (tile_r + tile_c) * (1 + taps)
    assert 4 * 4 * (2 * stage + tile_r * stride) <= 232448
