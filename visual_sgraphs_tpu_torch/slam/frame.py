"""Per-frame observations: ORB keypoints + depth, ready for tracking.

Port of the RGB-D pinhole branch of ``visual_sgraphs_tpu/slam/frame.py``
(Frame.cc:314-415): ORB extraction and the nearest-pixel depth lookup.
The rad-tan / Kannala-Brandt undistortion and the stereo frame are not on
the RGB-D path and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch.config import CameraConfig, OrbConfig
from visual_sgraphs_tpu_torch.features.orb import OrbParams, extract_orb


class FrameObs(NamedTuple):
    """One frame's fixed-capacity observation set (F keypoints)."""

    uv: torch.Tensor  # (F, 2) pixel coords
    depth: torch.Tensor  # (F,) metric depth, <=0 unknown
    level: torch.Tensor  # (F,) int32
    angle: torch.Tensor  # (F,)
    desc: torch.Tensor  # (F, 32) uint8
    valid: torch.Tensor  # (F,) bool
    timestamp: torch.Tensor  # () float32


def orb_params(orb: OrbConfig) -> OrbParams:
    return OrbParams(
        n_features=orb.n_features,
        n_levels=orb.n_levels,
        scale=orb.scale_factor,
        ini_thresh=orb.ini_fast_thresh,
        min_thresh=orb.min_fast_thresh,
    )


def make_frame_obs(gray: torch.Tensor, depth_img: torch.Tensor | None,
                   timestamp, cam: CameraConfig, orb: OrbConfig) -> FrameObs:
    """Extract ORB + look up depth at keypoints.

    ``gray``: (H, W) float32 [0, 255]; ``depth_img``: (H, W) metric depth,
    or None (every keypoint depthless).  A (B, H, W) batch of frames with
    (B, H, W) depths and B timestamps gives a FrameObs whose fields carry
    a leading B, each frame's equal to its extraction alone.  Everything
    runs on ``gray``'s device."""
    if any(abs(d) > 0 for d in (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)) \
            or getattr(cam, "model", "pinhole") != "pinhole":
        raise NotImplementedError(
            "make_frame_obs: undistortion (rad-tan / kb8) is not ported yet")
    kp = extract_orb(gray, orb_params(orb))
    if depth_img is not None:
        r = torch.clamp(torch.round(kp.uv[..., 1]).long(), 0,
                        depth_img.shape[-2] - 1)
        c = torch.clamp(torch.round(kp.uv[..., 0]).long(), 0,
                        depth_img.shape[-1] - 1)
        if gray.dim() == 3:
            b = torch.arange(gray.shape[0], device=gray.device)[:, None]
            depth = depth_img[b, r, c]
        else:
            depth = depth_img[r, c]
        depth = torch.where(depth > 0, depth, -1.0)
    else:
        depth = torch.full(kp.uv.shape[:-1], -1.0, dtype=torch.float32,
                           device=gray.device)
    if gray.dim() == 3:
        ts = torch.tensor([float(t) for t in timestamp],
                          dtype=torch.float32)
        if gray.is_cuda:  # pinned and non-blocking: no host sync
            ts = ts.pin_memory().to(gray.device, non_blocking=True)
    else:
        ts = torch.full((), float(timestamp), dtype=torch.float32,
                        device=gray.device)
    return FrameObs(
        uv=kp.uv,
        depth=depth,
        level=kp.level,
        angle=kp.angle,
        desc=kp.desc,
        valid=kp.valid,
        timestamp=ts,
    )


def frame_at(frames: FrameObs, i: int) -> FrameObs:
    """Frame ``i`` of a batched FrameObs."""
    return FrameObs(*(x[i] for x in frames))
