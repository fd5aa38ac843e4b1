"""Window-restricted binary-descriptor matching (kernel K5).

Port of ``match_window`` / ``hamming_matrix`` from
``visual_sgraphs_tpu/features/match.py`` (SearchByProjection semantics):
for every query ``a`` with a predicted pixel, the nearest target ``b``
within ``radius`` px (and ``level_slack`` levels, when levels are given),
best-2 with lax.top_k's lower-index-first tie order, the ``max_dist`` and
ratio gate, and duplicate targets resolved by keeping the lowest-distance
claimants.  ``match_window`` launches the hand kernel in ``csrc/match.cu``
on CUDA tensors and runs the plain twin ``match_window_torch`` on CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda

TH_LOW = 50
TH_HIGH = 100
BIG = 10_000


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 256) float32 in {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances (exact: sums of 0/1 in float32)."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    pa = a.sum(1, keepdim=True)
    pb = b.sum(1, keepdim=True)
    return (pa + pb.T - 2.0 * (a @ b.T)).to(torch.int32)


def match_window_torch(desc_a, uv_pred_a, valid_a, desc_b, uv_b, valid_b,
                       radius: float, level_a=None, level_b=None,
                       level_slack: int = 1, ratio: float = 0.9,
                       max_dist: int = TH_HIGH):
    """Plain PyTorch twin of K5.  Returns (matches (Na,) int32 into b or
    -1, dist (Na,) int32, 10000 where unmatched)."""
    if desc_a.is_cuda:
        match_window_torch.cuda_calls += 1
    d = hamming_matrix(desc_a, desc_b)
    du = uv_pred_a[:, None, 0] - uv_b[None, :, 0]
    dv = uv_pred_a[:, None, 1] - uv_b[None, :, 1]
    r2 = float(np.float32(radius * radius))
    mask = ((du * du + dv * dv) <= r2) & valid_a[:, None] & valid_b[None, :]
    if level_a is not None and level_b is not None:
        dl = torch.abs(level_a[:, None] - level_b[None, :])
        mask = mask & (dl <= level_slack)
    d = torch.where(mask, d, BIG)
    # best = first minimum (argmin returns the lowest index on ties);
    # second = the next value of the sorted row, duplicates included
    nn = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    best = d[rows, nn]
    d[rows, nn] = torch.iinfo(torch.int32).max
    second = d.amin(dim=1)
    ok = (best <= max_dist) & (
        best.to(torch.float32) <= ratio * second.to(torch.float32))
    n_b = desc_b.shape[0]
    claimed = torch.full((n_b,), BIG, dtype=best.dtype, device=d.device)
    claimed = claimed.scatter_reduce(
        0, torch.where(ok, nn, n_b - 1), torch.where(ok, best, BIG), "amin")
    ok = ok & (best <= claimed[nn])
    return (torch.where(ok, nn, -1).to(torch.int32),
            torch.where(ok, best, BIG).to(torch.int32))


match_window_torch.cuda_calls = 0


def match_window(desc_a, uv_pred_a, valid_a, desc_b, uv_b, valid_b,
                 radius: float, level_a=None, level_b=None,
                 level_slack: int = 1, ratio: float = 0.9,
                 max_dist: int = TH_HIGH):
    """Window matcher (kernel K5 on CUDA tensors, the twin on CPU)."""
    if desc_a.device.type == "cpu":
        return match_window_torch(desc_a, uv_pred_a, valid_a, desc_b, uv_b,
                                  valid_b, radius, level_a, level_b,
                                  level_slack, ratio, max_dist)
    use_level = level_a is not None and level_b is not None
    tensors = [desc_a, uv_pred_a, valid_a, desc_b, uv_b, valid_b]
    if use_level:
        tensors += [level_a, level_b]
    cuda.require_cuda("match_window", *tensors)
    for desc in (desc_a, desc_b):
        if (desc.dtype != torch.uint8 or desc.shape[1] != 32
                or desc.data_ptr() % 4):
            raise ValueError("match_window: descriptors must be (N, 32) "
                             "uint8 on a 4-byte boundary")
    if uv_pred_a.dtype != torch.float32 or uv_b.dtype != torch.float32:
        raise ValueError("match_window: pixels must be float32")
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("match_window: validity masks must be bool")
    if use_level and (level_a.dtype != torch.int32
                      or level_b.dtype != torch.int32):
        raise ValueError("match_window: levels must be int32")
    n_a, n_b = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    match = torch.empty((n_a,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_a,), dtype=torch.int32, device=dev)
    claimed = torch.full((n_b,), BIG, dtype=torch.int32, device=dev)
    cuda.call(
        "vsg_match_window", cuda.ptr(desc_a), cuda.ptr(uv_pred_a),
        cuda.ptr(valid_a), cuda.ptr(level_a) if use_level else None,
        cuda.ptr(desc_b), cuda.ptr(uv_b), cuda.ptr(valid_b),
        cuda.ptr(level_b) if use_level else None, n_a, n_b,
        float(np.float32(radius * radius)), int(level_slack),
        float(np.float32(ratio)), int(max_dist), cuda.ptr(match),
        cuda.ptr(dist), cuda.ptr(claimed), cuda.stream())
    match_window.launches += 1
    return match, dist


match_window.launches = 0
