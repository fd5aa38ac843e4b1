"""Per-detection statistics of the plane detector (kernel K14).

Port of the epilogue of ``visual_sgraphs_tpu/scenegraph/manager.py::
detect_planes_from_depth`` (manager.py:254-299): for each detected plane,
the member mask of the raw strided cloud (distance below 1.5x the RANSAC
threshold), the member count, the world-frame centroid, the confidence-
weighted class votes (normalised to one vote in all), the Gij point
quadric in the camera frame (normalised by the confidence mass) and the
``(n_det, V)`` surface-membership voxel rows (each member point projected
onto its world plane, quantised and hashed; duplicate slots keep the
larger key, the reference's ``.at[].max``).

``plane_epilogue`` launches the hand kernel in ``csrc/plane_epilogue.cu``
on CUDA tensors and runs the plain twin ``plane_epilogue_torch`` on CPU
tensors.  The twin writes every product and sum as its own rounded
operation, in the kernel's order, so the voxel keys agree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.scenegraph.state import (
    MEMBERSHIP_VOXEL,
    N_CLASSES,
    dot3,
    reciprocal_f32,
    voxel_key,
    voxel_slot,
)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def apply_pose(T, p):
    """``lie.se3_apply(T, p)`` with every operation rounded on its own
    (v + w·uv + q×uv + t, uv = 2 q×v)."""
    qv = T[1:4]
    uv = 2.0 * _cross(qv.expand_as(p), p)
    return ((p + T[0] * uv) + _cross(qv.expand_as(uv), uv)) + T[4:7]


def member_threshold(dist_thresh: float) -> float:
    """1.5x the RANSAC threshold, rounded as the reference's traced
    float32 product."""
    return float(np.float32(np.float32(dist_thresh) * np.float32(1.5)))


def plane_epilogue_torch(pts_cam, valid, labels, conf, coeffs_c, coeffs_w,
                         T_wc, member_thresh: float, vox_slots: int = 512):
    """Plain twin of K14.  Returns (npts (D,), centroid (D, 3) world,
    votes (D, N_CLASSES), quad (D, 4, 4), det_vox (D, V) int32)."""
    if pts_cam.is_cuda:
        plane_epilogue_torch.cuda_calls += 1
    D = coeffs_c.shape[0]
    pts_w = apply_pose(T_wc, pts_cam)
    dists = torch.abs(dot3(coeffs_c[:, None, :3], pts_cam)
                      + coeffs_c[:, 3:4])  # (D, M)
    member = (dists < member_thresh) & valid[None, :]
    memf = member.to(torch.float32)
    memw = memf * conf[None, :]
    npts = torch.sum(memf, dim=1)
    centroid = (memf @ pts_w) / torch.clamp(npts, min=1.0)[:, None]
    votes = torch.stack([torch.sum(memw * (labels == c)[None, :], dim=1)
                         for c in range(N_CLASSES)], dim=-1)
    votes = votes / torch.clamp(torch.sum(votes, dim=-1, keepdim=True),
                                min=1.0)
    ph = torch.cat([pts_cam, torch.ones_like(pts_cam[:, :1])], dim=-1)
    quad = torch.einsum("dn,ni,nj->dij", memw, ph, ph) / torch.clamp(
        torch.sum(memw, dim=1), min=1.0)[:, None, None]
    # surface-membership voxel keys of the member points projected onto
    # their world plane
    nvec = coeffs_w[:, :3]
    sd = dot3(nvec[:, None, :], pts_w[None, :, :]) + coeffs_w[:, 3:4]
    proj = pts_w[None, :, :] - sd[:, :, None] * nvec[:, None, :]
    keys = voxel_key(proj, MEMBERSHIP_VOXEL)  # (D, M)
    slots = voxel_slot(keys, vox_slots)
    rows = torch.arange(D, device=keys.device)[:, None].expand_as(keys)
    flat = torch.where(member, rows * vox_slots + slots, 0).reshape(-1)
    det_vox = torch.full((D * vox_slots,), -1, dtype=torch.int32,
                         device=keys.device)
    det_vox.scatter_reduce_(0, flat.long(),
                            torch.where(member, keys, -1).reshape(-1), "amax")
    return npts, centroid, votes, quad, det_vox.reshape(D, vox_slots)


plane_epilogue_torch.cuda_calls = 0


def plane_epilogue(pts_cam, valid, labels, conf, coeffs_c, coeffs_w, T_wc,
                   member_thresh: float, vox_slots: int = 512):
    """Per-detection statistics (kernel K14 on CUDA tensors, the twin on
    CPU).  Same arguments and results as ``plane_epilogue_torch``."""
    if pts_cam.device.type == "cpu":
        return plane_epilogue_torch(pts_cam, valid, labels, conf, coeffs_c,
                                    coeffs_w, T_wc, member_thresh, vox_slots)
    cuda.require_cuda("plane_epilogue", pts_cam, valid, labels, conf,
                      coeffs_c, coeffs_w, T_wc)
    for t in (pts_cam, conf, coeffs_c, coeffs_w, T_wc):
        if t.dtype != torch.float32:
            raise ValueError("plane_epilogue: float inputs must be float32")
    if valid.dtype != torch.bool or labels.dtype != torch.int32:
        raise ValueError("plane_epilogue: valid must be bool, labels int32")
    if coeffs_c.shape[0] > 8:
        raise ValueError("plane_epilogue: at most 8 detections")
    M, D = pts_cam.shape[0], coeffs_c.shape[0]
    dev = pts_cam.device
    acc = torch.empty((D, 17), dtype=torch.float32, device=dev)
    npts = torch.empty((D,), dtype=torch.float32, device=dev)
    centroid = torch.empty((D, 3), dtype=torch.float32, device=dev)
    votes = torch.empty((D, N_CLASSES), dtype=torch.float32, device=dev)
    quad = torch.empty((D, 4, 4), dtype=torch.float32, device=dev)
    det_vox = torch.empty((D, vox_slots), dtype=torch.int32, device=dev)
    cuda.call(
        "vsg_plane_epilogue", cuda.ptr(pts_cam), cuda.ptr(valid),
        cuda.ptr(labels), cuda.ptr(conf), cuda.ptr(coeffs_c),
        cuda.ptr(coeffs_w), cuda.ptr(T_wc), M, D,
        float(np.float32(member_thresh)), reciprocal_f32(MEMBERSHIP_VOXEL),
        vox_slots, cuda.ptr(acc),
        cuda.ptr(npts), cuda.ptr(centroid), cuda.ptr(votes), cuda.ptr(quad),
        cuda.ptr(det_vox), cuda.stream())
    plane_epilogue.launches += 1
    return npts, centroid, votes, quad, det_vox


plane_epilogue.launches = 0
