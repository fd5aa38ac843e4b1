"""Pinhole projection and back-projection on torch tensors.

Port of the pinhole part of ``visual_sgraphs_tpu/core/cameras.py``: a flat
``[fx, fy, cx, cy]`` parameter vector, no distortion.  The rad-tan and
Kannala-Brandt models are not on the RGB-D path and are not ported yet.
"""

from __future__ import annotations

import torch


def project_pinhole(params, p_cam):
    """Project camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * p_cam[..., 0] * inv_z + cx
    v = fy * p_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def unproject_pinhole(params, uv, depth=None):
    """Pixels (..., 2) -> unit-depth rays (..., 3) (or scaled by depth)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray

