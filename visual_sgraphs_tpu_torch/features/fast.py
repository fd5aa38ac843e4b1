"""FAST-9/16 corner score + 3x3 non-maximum suppression (kernel K2).

Port of ``visual_sgraphs_tpu/features/fast.py``.  ``fast_levels`` is the
dispatcher the ORB extractor calls once an extraction: on CUDA tensors it
launches the hand kernel in ``csrc/fast.cu`` once for every level of every
frame (the levels' descriptors a by-value kernel parameter, the scores
views of one allocation); on CPU tensors it runs the plain PyTorch twin
``fast_levels_torch``, ``fast_nms_torch`` on each level.  ``fast_nms`` is
the same kernel on one level.  Score: ``max(min over some 9-arc of (ring -
p), min over some 9-arc of (p - ring))``, 0 outside the 3-pixel border,
kept only where it is >= its 3x3 neighbourhood maximum.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visual_sgraphs_tpu_torch import cuda

# Bresenham circle of radius 3 (row, col offsets), OpenCV ordering
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9


def fast_score_torch(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (plain PyTorch) of (..., H, W)
    images; 3-px border is 0."""
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    pad = F.pad(x, (3, 3, 3, 3), mode="replicate")[:, 0]
    ring = torch.stack([pad[:, 3 + dr:3 + dr + h, 3 + dc:3 + dc + w]
                        for dr, dc in RING_OFFSETS])
    diff = ring - x[None, :, 0]

    def arc_extreme(d):
        mins = []
        for s in range(16):
            idx = [(s + i) % 16 for i in range(ARC_LEN)]
            mins.append(torch.amin(d[idx], dim=0))
        return torch.amax(torch.stack(mins), dim=0)

    score = torch.maximum(arc_extreme(diff), arc_extreme(-diff))
    score = torch.clamp(score, min=0.0)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    interior = (rows >= 3) & (rows < h - 3) & (cols >= 3) & (cols < w - 3)
    return torch.where(interior, score, 0.0).reshape(img.shape)


def nms3x3_torch(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf outside the image) of (..., H, W)
    score images."""
    h, w = score.shape[-2:]
    neigh = F.max_pool2d(score.reshape(-1, 1, h, w), 3, stride=1,
                         padding=1).reshape(score.shape)
    return torch.where(score >= neigh, score, 0.0)


def fast_nms_torch(img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the K2 kernel: nms3x3(fast_score(img))."""
    if img.is_cuda:
        fast_nms_torch.cuda_calls += 1
    return nms3x3_torch(fast_score_torch(img))


fast_nms_torch.cuda_calls = 0


# levels a K2 launch takes (the kernel's descriptor table)
MAX_LEVELS = 8
# K2's output tiles: TILE x TILE pixels, a CTA each
TILE = 32


def fast_tile_plan(shapes) -> tuple[list[int], int]:
    """K2's launch plan over levels of ``shapes`` [(h, w)]: (h, w, tiles
    across, first tile) per level, and the tiles a frame (the grid's
    x extent; a CTA's level is the last whose first tile is <= its
    index)."""
    plan, n = [], 0
    for h, w in shapes:
        tx = -(-w // TILE)
        plan += [h, w, tx, n]
        n += tx * -(-h // TILE)
    if n >= 2**31:
        raise ValueError("fast_levels: more than 2^31 - 1 tiles a frame")
    return plan, n


def fast_levels_torch(levels):
    """Plain twin of K2 over an extraction: ``fast_nms_torch`` on each
    level (None, a level without a budget, stays None)."""
    if any(lv is not None and lv.is_cuda for lv in levels):
        fast_levels_torch.cuda_calls += 1
    return [None if lv is None else fast_nms_torch(lv) for lv in levels]


fast_levels_torch.cuda_calls = 0


def fast_levels(levels):
    """FAST score + NMS of every level of an extraction (``levels[lv]``:
    (H_lv, W_lv) or (B, H_lv, W_lv) float32, one batch; None for a level
    without a budget, returned as None): kernel K2, one launch for every
    level and frame, on CUDA tensors (the scores are views of one
    allocation); the plain twin on CPU tensors."""
    live = [lv for lv in levels if lv is not None]
    if live[0].device.type == "cpu":
        return fast_levels_torch(levels)
    scores = iter(_fast_launch(live, "fast_levels"))
    return [None if lv is None else next(scores) for lv in levels]


fast_levels.launches = 0


def _fast_launch(live, name: str) -> list[torch.Tensor]:
    """One launch of K2 over the levels ``live``; their score images."""
    cuda.require_cuda(name, *live)
    lead = live[0].shape[:-2]
    if (len(live) > MAX_LEVELS
            or any(lv.dtype != torch.float32 or lv.dim() not in (2, 3)
                   or lv.shape[:-2] != lead or 0 in lv.shape[-2:]
                   for lv in live)):
        raise ValueError(f"{name}: expected at most {MAX_LEVELS} non-empty "
                         "float32 (H, W) or (B, H, W) levels of one batch")
    offsets = [0]
    for lv in live:
        offsets.append(offsets[-1] + lv.numel())
    buf = torch.empty(offsets[-1], dtype=torch.float32,
                      device=live[0].device)
    outs = [buf.as_strided(lv.shape, lv.stride(), off)
            for lv, off in zip(live, offsets)]
    plan, n_tiles = fast_tile_plan(lv.shape[-2:] for lv in live)
    cuda.call("vsg_fast_levels", cuda.ptr_array(live), cuda.ptr_array(outs),
              (ctypes.c_int * len(plan))(*plan), len(live), n_tiles,
              offsets[1] // (plan[0] * plan[1]), cuda.stream())
    fast_levels.launches += 1
    return outs


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """FAST score + NMS of one (H, W) float32 level, or of a (B, H, W)
    batch of levels: K2 with one level's descriptor on CUDA tensors, the
    plain twin on CPU tensors."""
    if img.device.type == "cpu":
        return fast_nms_torch(img)
    return _fast_launch([img], "fast_nms")[0]
