"""Fixed-shape point-cloud operations (kernel K12).

Port of ``visual_sgraphs_tpu/scenegraph/pointcloud.py``: a strided
backprojection of the depth image and a hash-scatter voxel downsample
(one centroid and mean confidence per occupied voxel, the first ``n_out``
occupied hash slots in ascending order).  ``depth_cloud`` is the keyframe
path's entry: on CUDA tensors it launches the hand kernel in
``csrc/voxel.cu`` (backprojection, per-pixel label / confidence gather,
hash scatter and sync-free compaction), on CPU tensors it runs the plain
twin ``depth_cloud_torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.scenegraph.state import UNDEFINED, reciprocal_f32
from visual_sgraphs_tpu_torch.slam.map_state import compact_true_torch

# the reference's spatial hash (Teschner et al. primes)
HASH_PRIMES = (73856093, 19349663, 83492791)


def backproject_depth(depth_img, cam_K, stride: int = 4,
                      min_depth: float = 0.2, max_depth: float = 8.0):
    """Depth image -> camera-frame cloud on a strided pixel grid.
    Returns (points (M, 3), valid (M,), pixel_rc (M, 2) int64) with
    M = (H // stride) * (W // stride)."""
    h, w = depth_img.shape
    dev = depth_img.device
    rs = torch.arange(0, h - (h % stride), stride, device=dev)
    cs = torch.arange(0, w - (w % stride), stride, device=dev)
    rr, cc = torch.meshgrid(rs, cs, indexing="ij")
    rr, cc = rr.reshape(-1), cc.reshape(-1)
    d = depth_img[rr, cc]
    x = (cc.to(torch.float32) - cam_K[2]) / cam_K[0]
    y = (rr.to(torch.float32) - cam_K[3]) / cam_K[1]
    pts = torch.stack([x * d, y * d, d], dim=-1)
    valid = (d > min_depth) & (d < max_depth)
    return pts, valid, torch.stack([rr, cc], dim=-1)


def voxel_hash(points, voxel: float, table: int):
    """(M,) slot of each point's voxel in a ``table``-slot hash: int32
    multiply-xor (wrapping), then a remainder with the divisor's sign, as
    ``jnp``'s ``%`` computes it.  Coordinates are scaled by the float32
    reciprocal of ``voxel``, as the reference's compiled division by a
    constant is."""
    key = torch.floor(points * reciprocal_f32(voxel)).to(torch.int32)
    h = ((key[:, 0] * HASH_PRIMES[0]) ^ (key[:, 1] * HASH_PRIMES[1])
         ^ (key[:, 2] * HASH_PRIMES[2]))
    return torch.remainder(h, table)


def voxel_downsample(points, valid, voxel: float, n_out: int,
                     min_points_per_voxel: int = 1, point_weight=None):
    """Voxel-grid downsample: one centroid per occupied voxel (hash
    table of ``4 * n_out`` slots, first ``n_out`` occupied slots in
    ascending order; empty rows repeat slot 0, as the reference's
    ``nonzero(fill_value=-1)`` + ``maximum(idx, 0)`` gather does).
    Returns (centroids, valid) or, with weights, (centroids, valid,
    mean weights)."""
    table = 4 * n_out
    dev = points.device
    h = torch.where(valid, voxel_hash(points, voxel, table), table).long()
    sums = torch.zeros((table + 1, 3), dtype=points.dtype, device=dev)
    sums.index_add_(0, h, torch.where(valid[:, None], points, 0.0))
    counts = torch.zeros((table + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, h, valid.to(torch.int32))
    occupied = counts[:table] >= min_points_per_voxel
    denom = torch.clamp(counts[:table], min=1).to(points.dtype)
    centroids = sums[:table] / denom[:, None]
    idx = compact_true_torch(occupied, n_out)
    ok = idx >= 0
    safe = torch.clamp(idx, min=0)
    out_pts = centroids[safe]
    if point_weight is None:
        return out_pts, ok
    wsums = torch.zeros((table + 1,), dtype=points.dtype, device=dev)
    wsums.index_add_(0, h, torch.where(valid, point_weight, 0.0))
    return out_pts, ok, (wsums[:table] / denom)[safe]


def depth_cloud_torch(depth_img, sem_img, conf_img, cam_K, voxel: float,
                      n_out: int, stride: int = 4):
    """Plain twin of K12.  ``sem_img`` / ``conf_img``: (H, W) int32 class
    and float32 confidence images, or None (all UNDEFINED / all ones).
    Returns (points (M, 3), valid (M,), labels (M,) int32, conf (M,),
    cloud (n_out, 3), cloud_valid (n_out,), cloud_weight (n_out,))."""
    if depth_img.is_cuda:
        depth_cloud_torch.cuda_calls += 1
    pts, valid, rc = backproject_depth(depth_img, cam_K, stride)
    if sem_img is None:
        labels = torch.full(valid.shape, UNDEFINED, dtype=torch.int32,
                            device=pts.device)
    else:
        labels = sem_img[rc[:, 0], rc[:, 1]].to(torch.int32)
    if conf_img is None:
        conf = torch.ones(valid.shape, dtype=torch.float32, device=pts.device)
    else:
        conf = conf_img[rc[:, 0], rc[:, 1]].to(torch.float32)
    cloud, cvalid, cweight = voxel_downsample(pts, valid, voxel, n_out,
                                              point_weight=conf)
    return pts, valid, labels, conf, cloud, cvalid, cweight


depth_cloud_torch.cuda_calls = 0


def depth_cloud(depth_img, sem_img, conf_img, cam_K, voxel: float,
                n_out: int, stride: int = 4):
    """Backprojection + voxel downsample (kernel K12 on CUDA tensors, the
    twin on CPU).  Same arguments and results as ``depth_cloud_torch``."""
    if depth_img.device.type == "cpu":
        return depth_cloud_torch(depth_img, sem_img, conf_img, cam_K, voxel,
                                 n_out, stride)
    tensors = [depth_img, cam_K] + [t for t in (sem_img, conf_img)
                                    if t is not None]
    cuda.require_cuda("depth_cloud", *tensors)
    if depth_img.dtype != torch.float32 or cam_K.dtype != torch.float32:
        raise ValueError("depth_cloud: depth and cam_K must be float32")
    if sem_img is not None and (sem_img.dtype != torch.int32
                                or sem_img.shape != depth_img.shape):
        raise ValueError("depth_cloud: sem_img must be int32 of depth's "
                         "shape")
    if conf_img is not None and (conf_img.dtype != torch.float32
                                 or conf_img.shape != depth_img.shape):
        raise ValueError("depth_cloud: conf_img must be float32 of depth's "
                         "shape")
    h, w = depth_img.shape
    hs, ws = h // stride, w // stride
    M, table = hs * ws, 4 * n_out
    dev = depth_img.device
    pts = torch.empty((M, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((M,), dtype=torch.bool, device=dev)
    labels = torch.empty((M,), dtype=torch.int32, device=dev)
    conf = torch.empty((M,), dtype=torch.float32, device=dev)
    cloud = torch.empty((n_out, 3), dtype=torch.float32, device=dev)
    cvalid = torch.empty((n_out,), dtype=torch.bool, device=dev)
    cweight = torch.empty((n_out,), dtype=torch.float32, device=dev)
    acc = torch.empty((table + 1, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((table + 1,), dtype=torch.int32, device=dev)
    cuda.call(
        "vsg_depth_cloud", cuda.ptr(depth_img), cuda.ptr(sem_img),
        cuda.ptr(conf_img), cuda.ptr(cam_K), h, w, stride,
        reciprocal_f32(voxel), table, n_out, cuda.ptr(pts),
        cuda.ptr(valid), cuda.ptr(labels), cuda.ptr(conf), cuda.ptr(acc),
        cuda.ptr(counts), cuda.ptr(cloud), cuda.ptr(cvalid),
        cuda.ptr(cweight), cuda.stream())
    depth_cloud.launches += 1
    return pts, valid, labels, conf, cloud, cvalid, cweight


depth_cloud.launches = 0
