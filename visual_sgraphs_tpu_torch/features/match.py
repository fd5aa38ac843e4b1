"""Binary-descriptor matching (kernel K5), the tracking pass built on it,
and the guided re-match count of loop verification (kernel K16).

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
- ``guided_count_sim3`` (the tail of
  ``place/loop_closer.py::_loop_geometry``, its SearchByProjection
  verification): the rows of ``cur`` whose point, moved by the refined
  Sim3 and projected into ``cand``, lands within 8 px of a
  descriptor-compatible keypoint, in one launch (``guided_count_torch``
  is its twin's count);
- ``track_pass`` (one pass of ``slam/tracking.py::_track_frame_impl``):
  the local map projected at a pose, its visibility gates, the window
  match against the frame's keypoints and the gathers that feed the pose
  solve, K5's redesign as one launch (``csrc/track_pass.cu``).

Each wrapper launches its hand kernel in ``csrc/match.cu`` on CUDA tensors
and runs its plain twin (``*_torch``) on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import cameras, lie

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
    """NN-ratio matcher (kernel K5's second entry on CUDA tensors, one
    launch; the twin on CPU); the outputs of ``match_nn_ratio_torch``."""
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
    if (n_b < 1 or n_a > 36864 or desc_a.data_ptr() % 16
            or desc_b.data_ptr() % 16):
        raise ValueError("match_nn_ratio: 1 <= n_b, n_a <= 36864, "
                         "descriptors on a 16-byte boundary")
    dev = desc_a.device
    match = torch.empty((n_a,), dtype=torch.int32, device=dev)
    dist = torch.empty((n_a,), dtype=torch.int32, device=dev)
    # per row: nn, best, second; per column: best row (no fill: the
    # launch writes each before it reads it)
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
    """The count of the twin below: the number of rows of ``a`` with a
    keypoint of ``b`` within ``radius`` px of its projection (squared
    distance below radius^2) and within ``max_hamming`` bits.  Returns a
    0-d int32."""
    d2 = torch.sum((uv_proj[:, None, :] - uv_b[None, :, :]) ** 2, dim=-1)
    near = (d2 < radius * radius) & valid_a[:, None] & valid_b[None, :]
    guided = near & (hamming_matrix(desc_a, desc_b) <= max_hamming)
    return torch.any(guided, dim=1).sum(dtype=torch.int32)


def guided_count_sim3_torch(S_ab, p_a, obs_a, kp_valid_a, pt_valid, desc_a,
                            uv_b, kp_valid_b, desc_b, cam_K,
                            radius: float = 8.0, max_hamming: int = 64):
    """Plain twin of K16: loop verification's guided re-match count under
    the refined Sim3 ``S_ab`` (8,).  Rows of ``a`` (keyframe ``cur``: its
    points ``p_a`` (F, 3) in its camera frame, point ids ``obs_a``,
    keypoint validity and descriptors) count when the keypoint is valid and
    observed, its point is valid (``pt_valid``), the point moved by
    ``S_ab`` lies more than 0.05 in front of the camera, and its pinhole
    projection (``cam_K``) lands within ``radius`` px of a valid keypoint of
    ``b`` (``cand``: ``uv_b``, ``kp_valid_b``, ``desc_b``) within
    ``max_hamming`` bits.  Returns a 0-d int32."""
    if p_a.is_cuda:
        guided_count_sim3_torch.cuda_calls += 1
    pt_a = torch.clamp(obs_a, min=0).long()
    va_all = kp_valid_a & (obs_a >= 0) & pt_valid[pt_a]
    p_cam = lie.sim3_apply(S_ab, p_a)
    uv_proj = cameras.project_pinhole(cam_K, p_cam).contiguous()
    return guided_count_torch(uv_proj, va_all & (p_cam[:, 2] > 0.05),
                              desc_a, uv_b, kp_valid_b, desc_b, radius,
                              max_hamming)


guided_count_sim3_torch.cuda_calls = 0
GUIDED_MAX_B = 65536


def guided_count_sim3(S_ab, p_a, obs_a, kp_valid_a, pt_valid, desc_a, uv_b,
                      kp_valid_b, desc_b, cam_K, radius: float = 8.0,
                      max_hamming: int = 64):
    """Guided re-match count under the refined Sim3 (kernel K16 on CUDA
    tensors: the rows' validity, the Sim3, the projection, the gate and
    the count in one launch; the twin on CPU)."""
    if p_a.device.type == "cpu":
        return guided_count_sim3_torch(S_ab, p_a, obs_a, kp_valid_a,
                                       pt_valid, desc_a, uv_b, kp_valid_b,
                                       desc_b, cam_K, radius, max_hamming)
    tensors = (S_ab, p_a, obs_a, kp_valid_a, pt_valid, desc_a, uv_b,
               kp_valid_b, desc_b, cam_K)
    cuda.require_cuda("guided_count_sim3", *tensors)
    _check_desc("guided_count_sim3", desc_a, desc_b)
    n_a, n_b = p_a.shape[0], uv_b.shape[0]
    if (S_ab.dtype != torch.float32 or tuple(S_ab.shape) != (8,)
            or p_a.dtype != torch.float32 or tuple(p_a.shape) != (n_a, 3)
            or cam_K.dtype != torch.float32 or cam_K.numel() < 4
            or uv_b.dtype != torch.float32 or tuple(uv_b.shape) != (n_b, 2)
            or obs_a.dtype != torch.int32
            or any(t.dtype != torch.bool
                   for t in (kp_valid_a, pt_valid, kp_valid_b))
            or obs_a.shape[0] != n_a or kp_valid_a.shape[0] != n_a
            or desc_a.shape[0] != n_a or kp_valid_b.shape[0] != n_b
            or desc_b.shape[0] != n_b):
        raise ValueError("guided_count_sim3: float32 Sim3 (8,), points (F, "
                         "3), camera and pixels (F_b, 2); int32 point ids; "
                         "bool masks")
    if (n_b > GUIDED_MAX_B or desc_a.data_ptr() % 16
            or desc_b.data_ptr() % 16):
        raise ValueError(f"guided_count_sim3: n_b <= {GUIDED_MAX_B}, "
                         "descriptors on a 16-byte boundary")
    count = torch.empty((), dtype=torch.int32, device=p_a.device)
    cuda.call("vsg_guided_count_sim3", cuda.ptr(S_ab), cuda.ptr(cam_K),
              cuda.ptr(p_a), cuda.ptr(obs_a), cuda.ptr(kp_valid_a),
              cuda.ptr(pt_valid), cuda.ptr(desc_a), cuda.ptr(uv_b),
              cuda.ptr(kp_valid_b), cuda.ptr(desc_b), n_a, n_b,
              pt_valid.shape[0], float(np.float32(radius * radius)),
              int(max_hamming), cuda.ptr(count), cuda.stream())
    guided_count_sim3.launches += 1
    return count


guided_count_sim3.launches = 0


# ---------------------------------------------------------------------------
# the tracking pass: projection, visibility, window match, gathers (K5)
# ---------------------------------------------------------------------------


class TrackPass(NamedTuple):
    # uv_pred, vis, match and dist: None from the kernel without ``full``
    uv_pred: torch.Tensor | None  # (N, 2) float32 predicted pixels
    vis: torch.Tensor | None  # (N,) bool in front of the camera, in image
    vis_pt: torch.Tensor  # (N,) int32 the visible points' ids, else -1
    match: torch.Tensor | None  # (N,) int32 keypoint matched, -1 for none
    dist: torch.Tensor | None  # (N,) int32 its distance, 10000 for none
    ok: torch.Tensor  # (N,) bool match >= 0
    slot: torch.Tensor  # (N,) int64 max(match, 0), the gathers' index
    uv_m: torch.Tensor  # (N, 2) float32 the matched keypoint's pixel
    depth_m: torch.Tensor | None  # (N,) float32 its depth (want_depth)
    n_match: torch.Tensor  # () int32 matches


def track_pass_torch(pt_pos, pt_desc, ids, T, cam_K, img_wh, radius: float,
                     frame, want_depth: bool = True) -> TrackPass:
    """Plain twin of the tracking pass (reference ``slam/tracking.py``
    ``_track_frame_impl``'s ``predict_uv`` + ``match_window`` + gathers):
    the local points ``ids`` (-1 padded) of the map's ``pt_pos`` /
    ``pt_desc`` projected at pose ``T``, gated on depth > 0.05 and, with
    ``img_wh``, the image bounds, window-matched against ``frame``'s
    keypoints within ``radius`` px (``match_window_torch`` with its
    ratio 0.9 and distance gate TH_HIGH, as tracking calls it), and the
    matched keypoints' pixels (and depths) gathered, keypoint 0's where
    unmatched."""
    if ids.is_cuda:
        track_pass_torch.cuda_calls += 1
    valid = ids >= 0
    safe = torch.clamp(ids, min=0)
    p_cam = lie.se3_apply(T, pt_pos[safe])
    uv_pred = cameras.project_pinhole(cam_K, p_cam)
    vis = (p_cam[:, 2] > 0.05) & valid
    if img_wh is not None:
        w, h = img_wh
        vis = vis & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < w) & \
            (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < h)
    match, dist = match_window_torch(pt_desc[safe], uv_pred, vis, frame.desc,
                                     frame.uv, frame.valid, radius)
    ok = match >= 0
    slot = torch.clamp(match, min=0).long()
    return TrackPass(uv_pred=uv_pred, vis=vis,
                     vis_pt=torch.where(vis, ids, -1), match=match,
                     dist=dist, ok=ok, slot=slot, uv_m=frame.uv[slot],
                     depth_m=frame.depth[slot] if want_depth else None,
                     n_match=ok.sum(dtype=torch.int32))


track_pass_torch.cuda_calls = 0

# The tracking pass's launch plan (csrc/track_pass.cu): TRACK_THREADS
# queries a CTA before another CTA joins the cluster, up to TRACK_CLUSTER;
# the keypoints binned in cells at least the radius wide, at most
# TRACK_MAX_CELLS of them over the image (640 x 480 without img_wh: any
# extent is exact, the cells only prune); a query scans the cells its
# window's bounding box, radius + TRACK_MARGIN px, touches.  A CTA's
# shared memory holds TRACK_KP_BYTES a keypoint (descriptor, pixel,
# index, cell, claim), two ints a cell and the scan's warp sums.
TRACK_THREADS = 512
TRACK_CLUSTER = 8
TRACK_MAX_CELLS = 4096
TRACK_MARGIN = 1.0
TRACK_KP_BYTES = 52
TRACK_EXTENT = (640, 480)
TRACK_RATIO = float(np.float32(0.9))  # match_window's ratio, float32


class TrackPassPlan(NamedTuple):
    cluster: int  # CTAs
    chunk: int  # queries a CTA
    cell: float  # px, float32
    gx: int  # cells across
    gy: int  # cells down
    smem: int  # dynamic shared-memory bytes a CTA
    scalars: tuple  # the launch's float32 scalars: r2, rr, 1 / cell, w, h


@functools.lru_cache(maxsize=256)
def track_pass_plan(n: int, F: int, radius: float,
                    img_wh: tuple | None) -> TrackPassPlan:
    """The tracking pass's cluster, cell grid and shared memory for n
    queries, F keypoints and ``radius``; raises when F keypoints and the
    grid do not fit a CTA's shared memory."""
    w, h = img_wh if img_wh is not None else TRACK_EXTENT
    cell = float(np.float32(max(radius, 1.0)))
    while -(-w // cell) * -(-h // cell) > TRACK_MAX_CELLS:
        cell = float(np.float32(cell * 1.25))
    gx, gy = max(1, int(-(-w // cell))), max(1, int(-(-h // cell)))
    cluster = min(TRACK_CLUSTER, max(1, -(-n // TRACK_THREADS)))
    smem = TRACK_KP_BYTES * F + 8 * gx * gy + 4 + 4 * (TRACK_THREADS // 32)
    smem = -(-smem // 16) * 16
    if smem > cuda.SMEM_LIMIT:
        raise ValueError(f"track_pass: {F} keypoints exceed the kernel's "
                         "shared memory")
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return TrackPassPlan(cluster=cluster, chunk=-(-n // cluster), cell=cell,
                         gx=gx, gy=gy, smem=smem, scalars=(
                             f32(radius * radius), f32(radius + TRACK_MARGIN),
                             f32(1.0 / np.float32(cell)), f32(w), f32(h)))


def track_pass(pt_pos, pt_desc, ids, T, cam_K, img_wh, radius: float, frame,
               want_depth: bool = True, full: bool = False) -> TrackPass:
    """One tracking pass (see ``track_pass_torch``): K5's redesign as one
    launch on CUDA tensors (``csrc/track_pass.cu``: projection, gates,
    binned window match, claims and gathers; no host read, no fill), the
    plain twin on CPU tensors.  ``T`` and ``cam_K`` stay on the device;
    ``radius``, ``img_wh`` and the flags are launch arguments.  On CUDA
    tensors without ``full`` the fields the pose solve does not read
    (``uv_pred``, ``vis``, ``match``, ``dist``) are None: the kernel keeps
    match and dist in scratch and skips the prediction's writes."""
    if ids.device.type == "cpu":
        return track_pass_torch(pt_pos, pt_desc, ids, T, cam_K, img_wh,
                                radius, frame, want_depth)
    cuda.require_cuda("track_pass", pt_pos, pt_desc, ids, T, cam_K, frame.uv,
                      frame.desc, frame.valid,
                      *((frame.depth,) if want_depth else ()))
    if (pt_desc.data_ptr() % 16 or frame.desc.data_ptr() % 16
            or pt_desc.dtype != torch.uint8 or pt_desc.shape[1:] != (32,)
            or frame.desc.dtype != torch.uint8):
        raise ValueError("track_pass: descriptors must be (N, 32) uint8 on "
                         "a 16-byte boundary")
    f32 = torch.float32
    if (ids.dtype != torch.int32 or frame.valid.dtype != torch.bool
            or pt_pos.dtype != f32 or T.dtype != f32 or cam_K.dtype != f32
            or frame.uv.dtype != f32
            or (want_depth and frame.depth.dtype != f32)):
        raise ValueError("track_pass: expected int32 ids, float32 pixels, "
                         "poses and depths, a bool mask")
    n, F = ids.shape[0], frame.uv.shape[0]
    if F < 1:
        raise ValueError("track_pass: the frame has no keypoint slot")
    plan = track_pass_plan(n, F, float(radius), img_wh)
    r2, rr, inv_cell, w, h = plan.scalars
    # one buffer a dtype, split into the outputs (a wrapper's host time
    # counts: an allocation or a view costs microseconds); match and dist
    # are passed by address where they are not returned
    dev = ids.device
    uv_m, depth_m, uv_pred = torch.empty((5 * n,), dtype=f32, device=dev
                                         ).split((2 * n, n, 2 * n))
    it = torch.empty((3 * n + 1,), dtype=torch.int32, device=dev)
    vis_pt, md, n_match = it.split((n, 2 * n, 1))
    flags = torch.empty(((2 if full else 1) * n,), dtype=torch.bool,
                        device=dev)
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    p_md = md.data_ptr()
    cuda.call("vsg_track_pass", pt_pos.data_ptr(), pt_desc.data_ptr(),
              pt_pos.shape[0], ids.data_ptr(), n, T.data_ptr(),
              cam_K.data_ptr(), frame.uv.data_ptr(), frame.desc.data_ptr(),
              frame.valid.data_ptr(),
              frame.depth.data_ptr() if want_depth else None, F,
              int(img_wh is not None), w, h, r2, rr, inv_cell, plan.gx,
              plan.gy, TRACK_RATIO, TH_HIGH, plan.cluster, plan.chunk,
              plan.smem, uv_pred.data_ptr() if full else None,
              flags.data_ptr() + n if full else None, vis_pt.data_ptr(),
              p_md, p_md + 4 * n, flags.data_ptr(), slot.data_ptr(),
              uv_m.data_ptr(), depth_m.data_ptr() if want_depth else None,
              n_match.data_ptr(), cuda.stream())
    track_pass.launches += 1
    if not full:
        return TrackPass(uv_pred=None, vis=None, vis_pt=vis_pt, match=None,
                         dist=None, ok=flags, slot=slot, uv_m=uv_m.view(n, 2),
                         depth_m=depth_m if want_depth else None,
                         n_match=n_match[0])
    ok, vis = flags.split(n)
    match, dist = md.split(n)
    return TrackPass(uv_pred=uv_pred.view(n, 2), vis=vis, vis_pt=vis_pt,
                     match=match, dist=dist, ok=ok, slot=slot,
                     uv_m=uv_m.view(n, 2),
                     depth_m=depth_m if want_depth else None,
                     n_match=n_match[0])


track_pass.launches = 0
