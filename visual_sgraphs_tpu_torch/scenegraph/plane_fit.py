"""Batched weighted-RANSAC plane extraction (kernel K13).

Port of ``visual_sgraphs_tpu/scenegraph/plane_fit.py`` (Utils.cc:291-371
with the confidence-weighted SAC model of WeightedSACModelPlane.hpp:
21-49): every 3-point hypothesis is scored at once by the summed weight of
its inliers, the best one (lowest index on ties, as ``jnp.argmax``) is
refit by weighted total least squares, and ``extract_planes`` repeats
extract-and-remove for a fixed number of rounds.

Two departures from the reference, both deliberate:

- hypotheses are an explicit ``(n_planes, n_hyp, 3)`` index tensor in
  place of a JAX PRNG key (the caller draws them; tests feed the
  reference's own draws);
- the refit normal's sign is pinned so that the camera origin lies on the
  plane's positive side (``c >= 0`` in the camera frame).  The reference
  keeps whatever sign LAPACK's ``eigh`` returns, which flips between
  keyframes and leaves one physical plane as two map planes.

``extract_planes`` launches the hand kernel in ``csrc/ransac.cu`` (one
launch a detection, every round inside it) on CUDA tensors and runs the
plain twin ``extract_planes_torch`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import plane as plane_mod
from visual_sgraphs_tpu_torch.scenegraph.state import dot3


def hypothesis_planes(points, idx):
    """(H, 4) planes through the 3-point samples ``idx`` (H, 3) and their
    (H,) degeneracy flags."""
    p0, p1, p2 = points[idx[:, 0]], points[idx[:, 1]], points[idx[:, 2]]
    a, b = p1 - p0, p2 - p0
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    nn = torch.sqrt(dot3(n, n))
    degen = nn < 1e-8
    n = n / torch.clamp(nn, min=1e-12)[:, None]
    c = -dot3(n, p0)
    return torch.cat([n, c[:, None]], dim=-1), degen


def abs_distance(coeffs, points):
    """|n·p + c| of every point (N, 3) to every plane (..., 4)."""
    return torch.abs(dot3(coeffs[..., None, :3], points)
                     + coeffs[..., None, 3])


def pin_sign(coeffs):
    """Flip planes so that the origin lies on the positive side (c >= 0)."""
    return coeffs * torch.where(coeffs[..., 3:4] < 0, -1.0, 1.0)


def ransac_plane_torch(points, valid, weights, idx, dist_thresh: float):
    """One weighted-RANSAC plane fit over the hypotheses ``idx`` (H, 3).
    Returns (coeffs (4,), inlier mask (N,), score ()) of the refit plane."""
    ok_h = valid[idx].all(dim=1)
    coeffs, degen = hypothesis_planes(points, idx)
    inl = (abs_distance(coeffs, points) < dist_thresh) & valid[None, :]
    scores = torch.sum(inl * weights[None, :], dim=1)
    scores = torch.where(ok_h & ~degen, scores, -1.0)
    best = torch.argmax(scores)  # first maximum on ties
    best_mask = inl.index_select(0, best[None])[0]
    refined = pin_sign(plane_mod.fit_centroid_svd(
        points, torch.where(best_mask, weights, 0.0)))
    mask_r = (abs_distance(refined, points) < dist_thresh) & valid
    return refined, mask_r, torch.sum(mask_r * weights)


def extract_planes_torch(points, valid, weights, hyp_idx,
                         dist_thresh: float = 0.04,
                         min_inliers: float = 50.0):
    """Plain twin of K13: ``hyp_idx.shape[0]`` sequential extract-and-
    remove rounds.  Returns (coeffs (n_planes, 4), plane_valid
    (n_planes,), assignment (N,) int32 plane index or -1)."""
    if points.is_cuda:
        extract_planes_torch.cuda_calls += 1
    n_planes = hyp_idx.shape[0]
    coeffs_out, valid_out = [], []
    assign = torch.full(valid.shape, -1, dtype=torch.int32,
                        device=points.device)
    remaining = valid
    for i in range(n_planes):
        coeffs, mask, score = ransac_plane_torch(
            points, remaining, weights, hyp_idx[i].long(), dist_thresh)
        good = score >= min_inliers
        coeffs_out.append(torch.where(good, coeffs, 0.0))
        valid_out.append(good)
        take = mask & remaining & good
        assign = torch.where(take, i, assign)
        remaining = remaining & ~take
    return torch.stack(coeffs_out), torch.stack(valid_out), assign


extract_planes_torch.cuda_calls = 0


def extract_planes(points, valid, weights, hyp_idx,
                   dist_thresh: float = 0.04, min_inliers: float = 50.0):
    """Sequential weighted-RANSAC extraction (kernel K13 on CUDA tensors,
    the twin on CPU).  Same arguments and results as
    ``extract_planes_torch``."""
    if points.device.type == "cpu":
        return extract_planes_torch(points, valid, weights, hyp_idx,
                                    dist_thresh, min_inliers)
    cuda.require_cuda("extract_planes", points, valid, weights, hyp_idx)
    if points.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("extract_planes: points and weights must be float32")
    if valid.dtype != torch.bool or hyp_idx.dtype != torch.int32:
        raise ValueError("extract_planes: valid must be bool and hyp_idx "
                         "int32")
    n_planes, n_hyp, _ = hyp_idx.shape
    N = points.shape[0]
    dev = points.device
    coeffs = torch.empty((n_planes, 4), dtype=torch.float32, device=dev)
    pvalid = torch.empty((n_planes,), dtype=torch.bool, device=dev)
    assign = torch.empty((N,), dtype=torch.int32, device=dev)
    cuda.call(
        "vsg_extract_planes", cuda.ptr(points), cuda.ptr(valid),
        cuda.ptr(weights), cuda.ptr(hyp_idx), N, n_planes, n_hyp,
        float(np.float32(dist_thresh)), float(np.float32(min_inliers)),
        cuda.ptr(coeffs), cuda.ptr(pvalid), cuda.ptr(assign), cuda.stream())
    extract_planes.launches += 1
    return coeffs, pvalid, assign


extract_planes.launches = 0


def plane_centroid(points, mask):
    w = mask.to(points.dtype)
    s = torch.clamp(torch.sum(w), min=1.0)
    return torch.sum(points * w[:, None], dim=0) / s
