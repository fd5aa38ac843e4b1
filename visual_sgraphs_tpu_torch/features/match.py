"""Binary-descriptor matching (kernel K5) and the guided re-match count of
loop verification (kernel K16).

Port of ``visual_sgraphs_tpu/features/match.py``:

- ``match_window`` (SearchByProjection semantics): for every query ``a``
  with a predicted pixel, the nearest target ``b`` within ``radius`` px
  (and ``level_slack`` levels, when levels are given), best-2 with
  lax.top_k's lower-index-first tie order, the ``max_dist`` and ratio
  gate, and duplicate targets resolved by keeping the lowest-distance
  claimants;
- ``match_nn_ratio`` (SearchByBoW semantics): brute-force nearest
  neighbour with the Lowe ratio test, the mutual-best check and the
  30-bin rotation histogram;
- ``guided_count`` (``place/loop_closer.py::_loop_geometry``'s
  SearchByProjection verification): rows whose projection lands within
  8 px of a descriptor-compatible keypoint.

Each wrapper launches its hand kernel in ``csrc/match.cu`` on CUDA tensors
and runs its plain twin (``*_torch``) on CPU tensors.
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


# ---------------------------------------------------------------------------
# brute-force NN ratio matching with rotation consistency (rest of K5)
# ---------------------------------------------------------------------------

HISTO_BINS = 30
TWO_PI = 2 * np.pi


def _rotation_consistency(angle_a, angle_b, matches, ok):
    """Keep only matches whose angle difference falls in the 3 most popular
    of 30 histogram bins (ORBmatcher.cc rotation histogram)."""
    da = angle_a - angle_b[torch.clamp(matches, 0, angle_b.shape[0] - 1)
                           .long()]
    bins = torch.floor(torch.remainder(da, TWO_PI) / TWO_PI * HISTO_BINS
                       ).to(torch.int64) % HISTO_BINS
    counts = torch.zeros(HISTO_BINS, dtype=torch.int32, device=da.device)
    counts.scatter_add_(0, bins, ok.to(torch.int32))
    thresh = torch.topk(counts, 3).values[2]
    return ok & (counts[bins] >= torch.clamp(thresh, min=1))


def match_nn_ratio_torch(desc_a, valid_a, desc_b, valid_b,
                         ratio: float = 0.75, max_dist: int = TH_LOW,
                         angle_a=None, angle_b=None, mutual: bool = True):
    """Plain twin of K5's NN-ratio entry: brute-force nearest neighbour
    with the Lowe ratio test, the mutual-best check and the rotation
    histogram.  Returns (matches (Na,) int32 into b or -1, dist (Na,)
    int32, 10000 where unmatched)."""
    if desc_a.is_cuda:
        match_nn_ratio_torch.cuda_calls += 1
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_b[None, :] & valid_a[:, None], d, BIG)
    nn = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    best = d[rows, nn]
    d2 = d.clone()
    d2[rows, nn] = torch.iinfo(torch.int32).max
    second = d2.amin(dim=1)
    ok = (best <= max_dist) & (
        best.to(torch.float32) <= ratio * second.to(torch.float32))
    ok = ok & valid_a
    if mutual:
        back = torch.argmin(d, dim=0)  # (Nb,) first best row per column
        ok = ok & (back[nn] == rows)
    if angle_a is not None and angle_b is not None:
        ok = _rotation_consistency(angle_a, angle_b, nn, ok)
    return (torch.where(ok, nn, -1).to(torch.int32),
            torch.where(ok, best, BIG).to(torch.int32))


match_nn_ratio_torch.cuda_calls = 0


def _check_desc(name, *descs):
    for desc in descs:
        if (desc.dtype != torch.uint8 or desc.shape[1] != 32
                or desc.data_ptr() % 4):
            raise ValueError(f"{name}: descriptors must be (N, 32) uint8 on "
                             "a 4-byte boundary")


def match_nn_ratio(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.75,
                   max_dist: int = TH_LOW, angle_a=None, angle_b=None,
                   mutual: bool = True):
    """NN-ratio matcher (kernel K5's second entry on CUDA tensors, the
    twin on CPU); the outputs of ``match_nn_ratio_torch``."""
    if desc_a.device.type == "cpu":
        return match_nn_ratio_torch(desc_a, valid_a, desc_b, valid_b, ratio,
                                    max_dist, angle_a, angle_b, mutual)
    use_angle = angle_a is not None and angle_b is not None
    tensors = [desc_a, valid_a, desc_b, valid_b] + (
        [angle_a, angle_b] if use_angle else [])
    cuda.require_cuda("match_nn_ratio", *tensors)
    _check_desc("match_nn_ratio", desc_a, desc_b)
    if valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("match_nn_ratio: validity masks must be bool")
    if use_angle and (angle_a.dtype != torch.float32
                      or angle_b.dtype != torch.float32):
        raise ValueError("match_nn_ratio: angles must be float32")
    n_a, n_b = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    match = torch.empty((n_a,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_a,), dtype=torch.int32, device=dev)
    # per row: nn, best, second; per column: best row
    scratch = torch.empty((3 * n_a + n_b,), dtype=torch.int32, device=dev)
    cuda.call("vsg_match_nn_ratio", cuda.ptr(desc_a), cuda.ptr(valid_a),
              cuda.ptr(desc_b), cuda.ptr(valid_b),
              cuda.ptr(angle_a) if use_angle else None,
              cuda.ptr(angle_b) if use_angle else None, n_a, n_b,
              float(np.float32(ratio)), int(max_dist), int(mutual),
              cuda.ptr(scratch), cuda.ptr(match), cuda.ptr(dist),
              cuda.stream())
    match_nn_ratio.launches += 1
    return match, dist


match_nn_ratio.launches = 0


# ---------------------------------------------------------------------------
# guided re-match count of loop verification (K16)
# ---------------------------------------------------------------------------


def guided_count_torch(uv_proj, valid_a, desc_a, uv_b, valid_b, desc_b,
                       radius: float = 8.0, max_hamming: int = 64):
    """Plain twin of K16: the number of rows of ``a`` with a keypoint of
    ``b`` within ``radius`` px of its projection (squared distance below
    radius^2) and within ``max_hamming`` bits.  Returns a 0-d int32."""
    if uv_proj.is_cuda:
        guided_count_torch.cuda_calls += 1
    d2 = torch.sum((uv_proj[:, None, :] - uv_b[None, :, :]) ** 2, dim=-1)
    near = (d2 < radius * radius) & valid_a[:, None] & valid_b[None, :]
    guided = near & (hamming_matrix(desc_a, desc_b) <= max_hamming)
    return torch.any(guided, dim=1).sum(dtype=torch.int32)


guided_count_torch.cuda_calls = 0


def guided_count(uv_proj, valid_a, desc_a, uv_b, valid_b, desc_b,
                 radius: float = 8.0, max_hamming: int = 64):
    """Guided re-match count (kernel K16 on CUDA tensors, the twin on
    CPU)."""
    if uv_proj.device.type == "cpu":
        return guided_count_torch(uv_proj, valid_a, desc_a, uv_b, valid_b,
                                  desc_b, radius, max_hamming)
    cuda.require_cuda("guided_count", uv_proj, valid_a, desc_a, uv_b,
                      valid_b, desc_b)
    _check_desc("guided_count", desc_a, desc_b)
    if uv_proj.dtype != torch.float32 or uv_b.dtype != torch.float32 \
            or valid_a.dtype != torch.bool or valid_b.dtype != torch.bool:
        raise ValueError("guided_count: float32 pixels and bool masks")
    count = torch.zeros((), dtype=torch.int32, device=uv_proj.device)
    cuda.call("vsg_guided_count", cuda.ptr(uv_proj), cuda.ptr(valid_a),
              cuda.ptr(desc_a), cuda.ptr(uv_b), cuda.ptr(valid_b),
              cuda.ptr(desc_b), uv_proj.shape[0], uv_b.shape[0],
              float(np.float32(radius * radius)), int(max_hamming),
              cuda.ptr(count), cuda.stream())
    guided_count.launches += 1
    return count


guided_count.launches = 0
