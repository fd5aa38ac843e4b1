"""Image pyramid: separable Gaussian blur + antialiased bilinear rescale (K1).

Port of ``visual_sgraphs_tpu/features/pyramid.py``.  The reference resizes
with ``jax.image.resize(..., "bilinear")``, which antialiases when it
downsamples: each output sample is a normalised triangle-kernel average
whose support widens by the inverse scale.  The port computes the same
separable weights once per (input, output) size, in float64 rounded once
to float32, and keeps each output's band of them (first source index and
``T`` taps; ``T`` = 3 at 1/1.2), accumulated with one fused multiply-add a
tap, the rounding of the dense weight product.

``gaussian_blur_levels`` and ``build_pyramid`` launch the hand kernels of
``csrc/pyramid.cu`` on CUDA tensors (the blur of every level of an
extraction in one launch, over ``blur_tile_plan``'s tiles; the whole
resize chain in one launch, from ``pyramid_table``'s packed bands) and run
the plain twins ``gaussian_blur_levels_torch`` / ``build_pyramid_torch``
on CPU tensors; ``gaussian_blur`` is the blur kernel on one level.  Each
takes images (H, W) or a batch (B, H, W); the twins round as the kernels
do, so on the card the two agree to the last bit (but for a rare double
rounding in the twin's float64 emulation of the resize's fused step).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda


@functools.lru_cache(maxsize=None)
def _gauss_kernel(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-half, half + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _blur_taps(ksize: int, sigma: float) -> list[float]:
    # taps as float32-rounded Python scalars: multiplying by a scalar
    # rounds like the reference's float32 tap array
    return [float(np.float32(v)) for v in _gauss_kernel(ksize, sigma)]


@functools.lru_cache(maxsize=None)
def _blur_taps_on(ksize: int, sigma: float,
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(_blur_taps(ksize, sigma), dtype=torch.float32,
                        device=device)


def _clamped(n: int, shift: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) + shift, 0, n - 1)


def gaussian_blur_torch(img: torch.Tensor, ksize: int = 7,
                        sigma: float = 2.0) -> torch.Tensor:
    """Plain twin of K1's blur: separable Gaussian of (..., H, W) images
    (replicate padding), vertical taps then horizontal, added in order."""
    if img.is_cuda:
        gaussian_blur_torch.cuda_calls += 1
    k = _blur_taps(ksize, sigma)
    half = ksize // 2
    h, w = img.shape[-2:]
    out = k[0] * img[..., _clamped(h, -half, img.device), :]
    for i in range(1, ksize):
        out = out + k[i] * img[..., _clamped(h, i - half, img.device), :]
    out2 = k[0] * out[..., _clamped(w, -half, img.device)]
    for i in range(1, ksize):
        out2 = out2 + k[i] * out[..., _clamped(w, i - half, img.device)]
    return out2


gaussian_blur_torch.cuda_calls = 0


# levels a blur launch takes (the kernel's descriptor table), and its
# output tile, rows x columns (csrc/pyramid.cu BLUR_MAX_LEVELS, BT_R, BT_C)
BLUR_MAX_LEVELS = 8
BLUR_TILE = (32, 64)


def blur_tile_plan(shapes) -> tuple[list[int], int]:
    """The blur's launch plan over levels of ``shapes`` [(h, w)]: (h, w,
    tiles across, first tile) per level, and the tiles a frame (the grid's
    x extent; a CTA's level is the last whose first tile is <= its
    index)."""
    plan, n = [], 0
    for h, w in shapes:
        tx = -(-w // BLUR_TILE[1])
        plan += [h, w, tx, n]
        n += tx * -(-h // BLUR_TILE[0])
    if n >= 2**31:
        raise ValueError("gaussian_blur_levels: more than 2^31 - 1 tiles a "
                         "frame")
    return plan, n


def gaussian_blur_levels_torch(levels):
    """Plain twin of K1's blur over an extraction: ``gaussian_blur_torch``
    on each level (None, a level without a budget, stays None)."""
    if any(lv is not None and lv.is_cuda for lv in levels):
        gaussian_blur_levels_torch.cuda_calls += 1
    return [None if lv is None else gaussian_blur_torch(lv) for lv in levels]


gaussian_blur_levels_torch.cuda_calls = 0


def gaussian_blur_levels(levels):
    """7-tap sigma-2 Gaussian blur of every level of an extraction
    (``levels[lv]``: (H_lv, W_lv) or (B, H_lv, W_lv) float32, one batch;
    None for a level without a budget, returned as None): kernel K1's
    blur, one launch for every level and frame, on CUDA tensors (the
    blurred levels are views of one level-major buffer); the plain twin on
    CPU tensors."""
    live = [lv for lv in levels if lv is not None]
    if not live:
        return list(levels)
    if live[0].device.type == "cpu":
        return gaussian_blur_levels_torch(levels)
    outs = iter(_blur_launch(live, "gaussian_blur_levels"))
    return [None if lv is None else next(outs) for lv in levels]


gaussian_blur_levels.launches = 0


@functools.lru_cache(maxsize=None)
def _blur_taps_host() -> ctypes.Array:
    return (ctypes.c_float * 7)(*_blur_taps(7, 2.0))


def _blur_launch(live, name: str) -> list[torch.Tensor]:
    """One launch of K1's blur over the levels ``live``; their blurred
    images."""
    cuda.require_cuda(name, *live)
    lead = live[0].shape[:-2]
    if (len(live) > BLUR_MAX_LEVELS
            or any(lv.dtype != torch.float32 or lv.dim() not in (2, 3)
                   or lv.shape[:-2] != lead or 0 in lv.shape[-2:]
                   for lv in live)):
        raise ValueError(f"{name}: expected at most {BLUR_MAX_LEVELS} "
                         "non-empty float32 (H, W) or (B, H, W) levels of "
                         "one batch")
    B = lead[0] if lead else 1
    if B > 65535:
        raise ValueError(f"{name}: more than 65535 frames")
    sizes = [lv.numel() for lv in live]
    buf = torch.empty((sum(sizes),), dtype=torch.float32,
                      device=live[0].device)
    outs = [v.view(lv.shape) for v, lv in zip(buf.split(sizes), live)]
    plan, n_tiles = blur_tile_plan(lv.shape[-2:] for lv in live)
    cuda.call("vsg_blur_levels", cuda.ptr_array(live), cuda.ptr_array(outs),
              (ctypes.c_int * len(plan))(*plan), len(live), n_tiles, B,
              _blur_taps_host(), cuda.stream())
    gaussian_blur_levels.launches += 1
    return outs


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """7-tap sigma-2 Gaussian blur of (H, W) or (B, H, W) float32 images:
    K1's blur with one level's descriptor on CUDA tensors, the plain twin
    on CPU tensors."""
    if img.device.type == "cpu":
        return gaussian_blur_torch(img, ksize, sigma)
    if (ksize, sigma) != (7, 2.0):
        raise ValueError("gaussian_blur: the K1 kernel has 7 taps, sigma 2")
    return _blur_launch([img], "gaussian_blur")[0]


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize's linear kernel
    with antialiasing (scale = n_out / n_in, no translation), computed in
    float64 and rounded once, as the reference computes them."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_band(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """(first (n_out,) int32, weights (n_out, T) float32): each output's
    non-zero weights of ``_resize_weights`` from its first source index on
    (zero where the band is shorter than ``T`` or runs past the input)."""
    wts = _resize_weights(n_in, n_out)
    nz = wts != 0
    any_nz = nz.any(axis=0)
    first = np.where(any_nz, nz.argmax(axis=0), 0)
    last = np.where(any_nz, n_in - 1 - nz[::-1].argmax(axis=0), 0)
    T = int(max(1, (last - first + 1).max()))
    idx = first[:, None] + np.arange(T)[None, :]
    band = np.where(idx < n_in, wts[np.minimum(idx, n_in - 1),
                                    np.arange(n_out)[:, None]], 0)
    return first.astype(np.int32), band.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_band_on(n_in: int, n_out: int, device: torch.device):
    first, band = resize_band(n_in, n_out)
    return (torch.from_numpy(first).to(device),
            torch.from_numpy(band).to(device))


def _band_apply(img: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """Each output's taps accumulated in order, one fused multiply-add a
    tap from 0 (a matrix product's rounding), emulated in float64: the
    float32 product is exact there and the sum rounds once more to
    float32."""
    n_in = img.shape[dim]
    first, band = _resize_band_on(n_in, n_out, img.device)
    shape = [1] * img.dim()
    shape[dim] = n_out
    acc = None
    for t in range(band.shape[1]):
        src = img.index_select(dim, torch.clamp(first.long() + t,
                                                max=n_in - 1)).double()
        term = band[:, t].double().reshape(shape) * src
        acc = (term if acc is None else term + acc.double()).float()
    return acc


def resize_bilinear_torch(img: torch.Tensor,
                          shape: tuple[int, int]) -> torch.Tensor:
    """One level of the twin's resize: the rows' band, then the columns',
    of (..., H, W) images; the taps added in order."""
    h, w = img.shape[-2:]
    out = img
    if shape[0] != h:
        out = _band_apply(out, shape[0], out.dim() - 2)
    if shape[1] != w:
        out = _band_apply(out, shape[1], out.dim() - 1)
    return out


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (height, width) list."""
    shapes = []
    for lv in range(n_levels):
        f = 1.0 / (scale**lv)
        shapes.append((max(16, int(round(h * f))), max(16, int(round(w * f)))))
    return shapes


# output rows x columns of the chain kernel's tile (csrc/pyramid.cu TO_R,
# TO_C); ints a level in the metadata
CHAIN_TILE = (32, 64)
CHAIN_META = 10


def _window(first: np.ndarray, T: int, n_in: int, tile: int) -> int:
    """The most input rows (or columns) one output tile's band covers."""
    if (np.diff(first) < 0).any():
        raise ValueError("pyramid_table: a band's first index decreases")
    starts = np.arange(0, len(first), tile)
    last = np.minimum(starts + tile - 1, len(first) - 1)
    hi = np.minimum(first[last] + T - 1, n_in - 1)
    return int((hi - first[starts] + 1).max())


@functools.lru_cache(maxsize=None)
def pyramid_table(h: int, w: int, n_levels: int, scale: float):
    """The resize chain's packed bands, as ``csrc/pyramid.cu`` reads them:
    (words (N,) int32: for each level 1.., the rows' first indices and
    their (ho, T) float32 weights as bits, then the columns'; meta
    (n_levels - 1, CHAIN_META) int32: hi, wi, ho, wo, the rows' first and
    weight offsets into ``words`` and taps, the columns' the same; the
    largest input window of a tile, (rows, columns)).  The bands are
    ``resize_band``'s (the identity, one tap of 1, where a size does not
    change)."""
    shapes = pyramid_shapes(h, w, n_levels, scale)
    words, meta, n = [np.zeros((0,), np.int32)], [], 0
    win = [0, 0]  # rows, columns
    for (hi, wi), (ho, wo) in zip(shapes[:-1], shapes[1:]):
        row = [hi, wi, ho, wo]
        for axis, n_in, n_out in ((0, hi, ho), (1, wi, wo)):
            first, band = resize_band(n_in, n_out)
            row += [n, n + n_out, band.shape[1]]
            words += [first, band.reshape(-1).view(np.int32)]
            n += n_out * (1 + band.shape[1])
            win[axis] = max(win[axis], _window(first, band.shape[1], n_in,
                                               CHAIN_TILE[axis]))
        meta.append(row)
    return (np.concatenate(words).astype(np.int32),
            np.asarray(meta, np.int32).reshape(-1, CHAIN_META), tuple(win))


@functools.lru_cache(maxsize=None)
def _chain_on(h: int, w: int, n_levels: int, scale: float,
              device: torch.device):
    words, meta, (win_r, win_c) = pyramid_table(h, w, n_levels, scale)
    return (torch.from_numpy(words).to(device),
            (ctypes.c_int * meta.size)(*meta.reshape(-1).tolist()),
            win_r, win_c, pyramid_shapes(h, w, n_levels, scale))


def _pyramid_chain(x: torch.Tensor, n_levels: int, scale: float,
                   cluster: int = 0) -> list[torch.Tensor]:
    """Levels 1.. of a contiguous float32 CUDA image (h, w) or batch
    (B, h, w) in one launch, as views of one level-major buffer;
    ``cluster`` CTAs a frame (0: 16 when every frame's cluster of 16 fits
    on the card at once, else 8, as ``build_pyramid`` runs it; 8 or 16 to
    compare)."""
    h, w = x.shape[-2:]
    B = x.numel() // (h * w)
    tab, meta, win_r, win_c, shapes = _chain_on(h, w, n_levels, scale,
                                                x.device)
    sizes = [B * a * b for a, b in shapes[1:]]
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=x.device)
    if B and sizes:
        cuda.call("vsg_pyramid", cuda.ptr(x), cuda.ptr(out), B,
                  cuda.ptr(tab), meta, n_levels - 1, win_r, win_c, cluster,
                  cuda.stream())
        build_pyramid.launches += 1
    lead = x.shape[:-2]
    return [v.view(*lead, *sh) for v, sh in zip(out.split(sizes),
                                                shapes[1:])]


def build_pyramid(img: torch.Tensor, n_levels: int = 8,
                  scale: float = 1.2) -> list[torch.Tensor]:
    """List of ``n_levels`` images (or (B, h, w) batches); level 0 is the
    input (float32), each later one resized from the one before: the
    whole chain in one launch of kernel K1 on a CUDA tensor (the levels
    are views of one buffer), the plain twin on a CPU tensor."""
    if img.device.type == "cpu":
        return build_pyramid_torch(img, n_levels, scale)
    x = img.to(torch.float32)
    cuda.require_cuda("build_pyramid", x)
    if x.dim() not in (2, 3):
        raise ValueError("expected an (H, W) image or a (B, H, W) batch")
    return [x] + _pyramid_chain(x, n_levels, scale)


build_pyramid.launches = 0


def build_pyramid_torch(img: torch.Tensor, n_levels: int = 8,
                        scale: float = 1.2) -> list[torch.Tensor]:
    """Plain twin of K1's resize chain: ``resize_bilinear_torch`` level
    after level."""
    if img.is_cuda:
        build_pyramid_torch.cuda_calls += 1
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img.to(torch.float32)]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear_torch(levels[-1], shapes[lv]))
    return levels


build_pyramid_torch.cuda_calls = 0
