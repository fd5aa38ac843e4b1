"""Image pyramid: separable Gaussian blur + antialiased bilinear rescale.

Port of ``visual_sgraphs_tpu/features/pyramid.py`` (K1, plain PyTorch).
The reference resizes with ``jax.image.resize(..., "bilinear")``, which
antialiases when it downsamples: each output sample is a normalised
triangle-kernel average whose support widens by the inverse scale.  The
port builds the same separable weights once per (input, output) size as
two dense matrices and applies them as two matrix products, so each level
agrees with the reference to float32 rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gauss_kernel(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-half, half + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of a 2D image (replicate padding)."""
    # taps as float32-rounded Python scalars: multiplying by a scalar
    # rounds like the reference's float32 tap array, without a copy to the
    # device per call
    k = [float(np.float32(v)) for v in _gauss_kernel(ksize, sigma)]
    half = ksize // 2
    h, w = img.shape
    pad = torch.nn.functional.pad(img[None, None], (0, 0, half, half),
                                  mode="replicate")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * pad[i:i + h]
    pad = torch.nn.functional.pad(out[None, None], (half, half, 0, 0),
                                  mode="replicate")[0, 0]
    out2 = torch.zeros_like(img)
    for i in range(ksize):
        out2 = out2 + k[i] * pad[:, i:i + w]
    return out2


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
def _resize_weights_on(n_in: int, n_out: int,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(n_in, n_out)).to(device)


def resize_bilinear(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    h, w = img.shape
    out = img
    if shape[0] != h:
        out = _resize_weights_on(h, shape[0], img.device).T @ out
    if shape[1] != w:
        out = out @ _resize_weights_on(w, shape[1], img.device)
    return out


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (height, width) list."""
    shapes = []
    for lv in range(n_levels):
        f = 1.0 / (scale**lv)
        shapes.append((max(16, int(round(h * f))), max(16, int(round(w * f)))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = 8,
                  scale: float = 1.2) -> list[torch.Tensor]:
    """List of ``n_levels`` images; level 0 is the input (float32)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img.to(torch.float32)]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lv]))
    return levels
