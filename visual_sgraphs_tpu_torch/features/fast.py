"""FAST-9/16 corner score + 3x3 non-maximum suppression (kernel K2).

Port of ``visual_sgraphs_tpu/features/fast.py``.  ``fast_nms`` is the
dispatcher the ORB extractor calls: on a CUDA tensor it launches the hand
kernel in ``csrc/fast.cu``; on a CPU tensor it runs the plain PyTorch twin
``fast_nms_torch``.  Score: ``max(min over some 9-arc of (ring - p), min
over some 9-arc of (p - ring))``, 0 outside the 3-pixel border, kept only
where it is >= its 3x3 neighbourhood maximum.
"""

from __future__ import annotations

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


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """FAST score + NMS of one (H, W) float32 level, or of a (B, H, W)
    batch of levels.  CUDA tensors go through the K2 kernel, CPU tensors
    through the plain twin."""
    if img.device.type == "cpu":
        return fast_nms_torch(img)
    cuda.require_cuda("fast_nms", img)
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError("fast_nms: expected a 2D or 3D float32 image")
    h, w = img.shape[-2:]
    tmp = torch.empty_like(img)
    out = torch.empty_like(img)
    cuda.call("vsg_fast_nms", cuda.ptr(img), cuda.ptr(tmp), cuda.ptr(out),
              img.numel() // (h * w), h, w, cuda.stream())
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
