"""Mapping: keyframe insertion + RGB-D point seeding, observation fusion,
point and keyframe culling.

Port of the RGB-D keyframe path of ``visual_sgraphs_tpu/slam/mapping.py``
(LocalMapping.cc:58-278): ``retire_keyframe``, ``insert_keyframe``,
``apply_found_stats``, ``fuse_observations``, ``cull_points`` and
``cull_keyframes``.  Functions return a new ``MapState`` and never modify
their input map.  On CUDA tensors the map maintenance runs as hand-written
kernels that write each changed field out of place: K27
(``csrc/kf_insert.cu``: ``apply_found_stats`` and ``insert_keyframe``),
K28 (``csrc/fuse_obs.cu``: ``fuse_candidates`` and ``fuse_writeback``
around ``fuse_observations``' tracking pass) and K29
(``csrc/map_cull.cu``: ``cull_map``, ``cull_points`` then
``cull_keyframes``).  Their plain twins (the ``*_torch`` functions, each
changed field cloned once and then updated in place) run on CPU tensors.

Scatters with repeated indices keep the reference's results: ``.max`` /
``.min`` / ``.add`` become ``scatter_reduce`` / ``scatter_add``, and a
plain ``.at[].set`` whose index can repeat goes through
``map_state.index_set_last`` (XLA applies the updates in order, so the last
one wins).  The keyframe program's local BA lives in ``optim/fast_ba.py``;
``local_ba`` is the LM windowed BA that the recovery keyframe, the loop
weld and the inertial path before its initialisation run, on the LM
engine's kernel route (``optim/lm_kernels.py``).  Monocular point
creation is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.features.match import track_pass
from visual_sgraphs_tpu_torch.optim import factors
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
from visual_sgraphs_tpu_torch.optim.graph import FactorBatch
from visual_sgraphs_tpu_torch.slam.frame import FrameObs
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    compact_observed,
    compact_plan,
    compact_true_torch,
    covisibility_counts,
    index_set_last,
    point_obs_count,
)
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable


def retire_keyframe(m: MapState, slot, do: torch.Tensor) -> MapState:
    """Retire keyframe ``slot`` (cull or capacity eviction), masked by the
    device bool ``do``: invalidate the slot, append (seq, parent_seq, T_cp)
    to the retirement ledger (when a parent exists and the ledger has room)
    and re-point ``pt_first_kf`` at the parent."""
    # ``slot`` may be a device scalar (the keyframe cull's choice), so
    # rows are read with index_select and written through one-hot masks:
    # indexing with a 0-d CUDA tensor would read it back to the host
    K, E = m.K, m.E
    dev = m.kf_seq.device
    at_slot = torch.arange(K, device=dev) == slot
    s = torch.argmax(at_slot.to(torch.int32)).reshape(1)
    seq_s = m.kf_seq.index_select(0, s)[0]
    cand = m.kf_valid & ~at_slot
    dist = torch.where(cand, torch.abs(m.kf_seq - seq_s), 2**30)
    parent = torch.argmin(dist).reshape(1)
    T_cp = lie.se3_normalize(lie.se3_multiply(
        m.kf_pose.index_select(0, s)[0],
        lie.se3_inverse(m.kf_pose.index_select(0, parent)[0])))
    any_cand = cand.any()
    write = do & any_cand & (m.led_n < E)
    at_e = (torch.arange(E, device=dev) == torch.clamp(m.led_n, max=E - 1)
            ) & write
    return m._replace(
        kf_valid=m.kf_valid & ~(at_slot & do),
        pt_first_kf=torch.where(
            do & any_cand & (m.pt_first_kf == slot),
            parent[0].to(m.pt_first_kf.dtype), m.pt_first_kf),
        led_seq=torch.where(at_e, seq_s, m.led_seq),
        led_parent_seq=torch.where(at_e, m.kf_seq.index_select(0, parent)[0],
                                   m.led_parent_seq),
        led_T_cp=torch.where(at_e[:, None], T_cp, m.led_T_cp),
        led_n=torch.clamp(m.led_n + write.to(torch.int32), max=E),
    )


def insert_keyframe_torch(m: MapState, frame: FrameObs, pose: torch.Tensor,
                          slot_pt: torch.Tensor, cam_K: torch.Tensor,
                          slot: int, quarantine: int = 3, stats=None):
    """Plain twin of K27's insert entry (see ``insert_keyframe``): the
    stats fold, the retirement, the allocation and the rows as eager
    torch operations."""
    if m.kf_valid.is_cuda:
        insert_keyframe_torch.cuda_calls += 1
    if stats is not None:
        m = apply_found_stats_torch(m, *stats)
    F = m.F
    k = int(slot)
    dev = m.kf_valid.device
    evicted = m.kf_valid[k]
    m = retire_keyframe(m, k, evicted)

    T_wc = lie.se3_inverse(pose)
    rays = cameras.unproject_pinhole(cam_K, frame.uv)
    p_world = lie.se3_apply(T_wc, rays * frame.depth[:, None])
    new_mask = frame.valid & (frame.depth > 0) & (slot_pt < 0)
    # freed ids stay quarantined for ``quarantine`` keyframes
    allocatable = ~m.pt_valid & (m.n_kf - m.pt_freed_seq >= quarantine)
    free_ids = compact_true_torch(allocatable, F)
    order = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    new_ids = torch.where(new_mask, free_ids[torch.clamp(order, 0, F - 1)],
                          -1)
    alloc = new_ids >= 0
    safe = torch.clamp(new_ids, min=0)

    def put(field, value):
        return index_set_last(field.clone(), safe, value)

    obs_pt = torch.where(alloc, new_ids, slot_pt.long()).to(torch.int32)

    def row(field, value):
        out = field.clone()
        out[k] = value
        return out

    new_m = m._replace(
        kf_pose=row(m.kf_pose, pose),
        kf_valid=row(m.kf_valid, torch.ones((), dtype=torch.bool,
                                            device=dev)),
        kf_timestamp=row(m.kf_timestamp, frame.timestamp),
        kf_uv=row(m.kf_uv, frame.uv),
        kf_depth=row(m.kf_depth, frame.depth),
        kf_level=row(m.kf_level, frame.level),
        kf_angle=row(m.kf_angle, frame.angle),
        kf_desc=row(m.kf_desc, frame.desc),
        kf_kp_valid=row(m.kf_kp_valid, frame.valid),
        kf_obs_pt=row(m.kf_obs_pt, obs_pt),
        kf_seq=row(m.kf_seq, m.n_kf),
        pt_pos=put(m.pt_pos, torch.where(alloc[:, None], p_world,
                                         m.pt_pos[safe])),
        pt_valid=put(m.pt_valid, alloc | m.pt_valid[safe]),
        pt_desc=put(m.pt_desc, torch.where(alloc[:, None], frame.desc,
                                           m.pt_desc[safe])),
        pt_first_kf=put(m.pt_first_kf, torch.where(
            alloc, torch.full((), k, dtype=torch.int32, device=dev),
            m.pt_first_kf[safe])),
        pt_first_seq=put(m.pt_first_seq, torch.where(
            alloc, m.n_kf, m.pt_first_seq[safe])),
        # reused point slots must not inherit the culled point's stats
        pt_visible=put(m.pt_visible, torch.where(
            alloc, torch.ones_like(m.pt_visible[safe]), m.pt_visible[safe])),
        pt_found=put(m.pt_found, torch.where(
            alloc, torch.ones_like(m.pt_found[safe]), m.pt_found[safe])),
        n_kf=m.n_kf + 1,
        n_pt=m.n_pt + alloc.sum(dtype=torch.int32),
    )
    return new_m, k, evicted


insert_keyframe_torch.cuda_calls = 0

# the map fields K27's insert entry writes (all but pt_freed_seq)
INSERT_FIELDS = tuple(f for f in MapState._fields if f != "pt_freed_seq")


def insert_keyframe(m: MapState, frame: FrameObs, pose: torch.Tensor,
                    slot_pt: torch.Tensor, cam_K: torch.Tensor, slot: int,
                    quarantine: int = 3, stats=None):
    """Write the frame into keyframe slot ``slot`` (chosen by the host) and
    seed new map points from keypoints with valid depth that matched no
    existing point (Tracking.cc:3318-3394).  A still-valid occupant of the
    slot retires through the ledger first.  ``stats`` = (slot_pts (B, F),
    vis_pts (B, n_local)) folds a keyframe program's found / visible
    tables first (``apply_found_stats``; the insertion then resets its new
    points' counters to 1).  One launch of kernel K27's insert entry
    (``csrc/kf_insert.cu``, every changed field written out of place) on
    CUDA tensors, the twin on CPU tensors.

    Returns (new_map, kf_slot, evicted: device bool)."""
    if m.kf_valid.device.type == "cpu":
        return insert_keyframe_torch(m, frame, pose, slot_pt, cam_K, slot,
                                     quarantine, stats)
    k = int(slot)
    K, F, N, E = m.K, m.F, m.N, m.E
    fr = (frame.uv, frame.depth, frame.level, frame.angle, frame.desc,
          frame.valid, frame.timestamp, pose, slot_pt, cam_K)
    fids, vids = stats if stats is not None else (None, None)
    cuda.require_cuda("insert_keyframe", *m, *fr,
                      *(t for t in (fids, vids) if t is not None))
    if (frame.uv.shape != (F, 2) or frame.desc.shape != (F, 32)
            or slot_pt.shape != (F,) or slot_pt.dtype != torch.int32
            or frame.level.dtype != torch.int32
            or frame.timestamp.dtype != torch.float32
            or pose.dtype != torch.float32 or pose.shape != (7,)
            or cam_K.dtype != torch.float32 or not 0 <= k < K
            or (fids is not None and (fids.dtype != torch.int32
                                      or vids.dtype != torch.int32
                                      or fids.shape[-1] != F))):
        raise ValueError("insert_keyframe: expected the map's F keypoints, "
                         "int32 slot_pt / levels / stats, float32 pose, "
                         "timestamp and camera, a slot below K")
    new = m._replace(**{f: torch.empty_like(getattr(m, f))
                        for f in INSERT_FIELDS})
    out = [getattr(new, f) if f in INSERT_FIELDS else None
           for f in MapState._fields]
    frows = 0 if fids is None else fids.numel() // F
    vlen = 0 if vids is None else vids.shape[-1]
    vrows = 0 if vids is None else vids.numel() // max(vlen, 1)
    cuda.call("vsg_kf_insert", cuda.ptr_array(list(m)), cuda.ptr_array(out),
              cuda.ptr_array(fr), K, F, N, E, k, quarantine, cuda.ptr(fids),
              frows, cuda.ptr(vids), vrows, vlen, cuda.stream())
    insert_keyframe.launches += 1
    return new, k, m.kf_valid[k]


insert_keyframe.launches = 0


def apply_found_stats_torch(m: MapState, slot_pts: torch.Tensor,
                            vis_pts: torch.Tensor | None = None,
                            packeds: torch.Tensor | None = None,
                            min_inliers: int = 0) -> MapState:
    """Plain twin of K27's stats entry (see ``apply_found_stats``)."""
    if m.pt_found.is_cuda:
        apply_found_stats_torch.cuda_calls += 1
    if packeds is not None:
        acc = packeds[:, 1] >= min_inliers
        slot_pts = torch.where(acc[:, None], slot_pts, -1)
        if vis_pts is not None:
            vis_pts = torch.where(acc[:, None], vis_pts, -1)
    flat = slot_pts.reshape(-1)
    pt_found = m.pt_found.scatter_add(
        0, torch.clamp(flat, min=0).long(), (flat >= 0).to(torch.int32))
    pt_visible = m.pt_visible
    if vis_pts is not None:
        vflat = vis_pts.reshape(-1)
        pt_visible = pt_visible.scatter_add(
            0, torch.clamp(vflat, min=0).long(), (vflat >= 0).to(torch.int32))
    return m._replace(pt_found=pt_found, pt_visible=pt_visible)


apply_found_stats_torch.cuda_calls = 0


def apply_found_stats(m: MapState, slot_pts: torch.Tensor,
                      vis_pts: torch.Tensor | None = None,
                      packeds: torch.Tensor | None = None,
                      min_inliers: int = 0) -> MapState:
    """Fold batches of per-frame match tables (B, F) into the found
    counters and visibility tables (B, n_local) into the visible counters
    (MapPoint::IncreaseFound/IncreaseVisible, accumulated lazily); with
    ``packeds`` (B, 4) only the frames whose packed inlier count reaches
    ``min_inliers`` (the cycle's accepted frames).  A single frame's (F,)
    / (n_local,) tables are one row.  One launch of kernel K27's stats
    entry (``csrc/kf_insert.cu``) on CUDA tensors, the twin on CPU
    tensors."""
    if m.pt_found.device.type == "cpu":
        return apply_found_stats_torch(m, slot_pts, vis_pts, packeds,
                                       min_inliers)
    cuda.require_cuda("apply_found_stats", m.pt_found, m.pt_visible,
                      slot_pts, *(t for t in (vis_pts, packeds)
                                  if t is not None))
    flen = slot_pts.shape[-1]
    frows = slot_pts.numel() // max(flen, 1)
    vlen = 0 if vis_pts is None else vis_pts.shape[-1]
    vrows = 0 if vis_pts is None else vis_pts.numel() // max(vlen, 1)
    if (slot_pts.dtype != torch.int32 or m.pt_found.dtype != torch.int32
            or (vis_pts is not None and (vis_pts.dtype != torch.int32
                                         or vrows != frows))
            or (packeds is not None and (packeds.dtype != torch.float32
                                         or packeds.shape != (frows, 4)))):
        raise ValueError("apply_found_stats: expected int32 counters and "
                         "ids, float32 (B, 4) packeds, as many visible rows "
                         "as found rows")
    pt_found = torch.empty_like(m.pt_found)
    pt_visible = torch.empty_like(m.pt_visible)
    cuda.call("vsg_found_stats", m.pt_found.data_ptr(),
              m.pt_visible.data_ptr(), m.N, slot_pts.data_ptr(), frows, flen,
              cuda.ptr(vis_pts), vrows, vlen, cuda.ptr(packeds),
              float(min_inliers), pt_found.data_ptr(), pt_visible.data_ptr(),
              cuda.stream())
    apply_found_stats.launches += 1
    return m._replace(pt_found=pt_found, pt_visible=pt_visible)


apply_found_stats.launches = 0


class KeyframeKeypoints(NamedTuple):
    """A keyframe's keypoints as the tracking pass reads a frame."""

    uv: torch.Tensor  # (F, 2) float32
    desc: torch.Tensor  # (F, 32) uint8
    valid: torch.Tensor  # (F,) bool


def fuse_candidates_torch(m: MapState, kf_id: int, n_local: int = 4096):
    """Plain twin of K28's prologue (see ``fuse_candidates``)."""
    if m.pt_valid.is_cuda:
        fuse_candidates_torch.cuda_calls += 1
    counts = covisibility_counts(m, kf_id)
    _, top_kfs = topk_stable(counts, 8)
    kf_mask = counts[top_kfs] > 0
    ids = compact_observed(m, top_kfs, kf_mask, n_local, torch.int32)
    free = m.kf_kp_valid[kf_id] & (m.kf_obs_pt[kf_id] < 0)
    return ids, KeyframeKeypoints(m.kf_uv[kf_id], m.kf_desc[kf_id], free)


fuse_candidates_torch.cuda_calls = 0


def fuse_candidates(m: MapState, kf_id: int, n_local: int = 4096):
    """``fuse_observations``' operands: (ids, keypoints), the (n_local,)
    int32 ids of the valid points that the top-8 covisible keyframes of
    ``kf_id`` observe (lax.top_k's order; ascending, -1 padded) and the
    keyframe's keypoints, valid where still unassociated.  One launch of
    kernel K28's prologue (``csrc/fuse_obs.cu``: the covisibility counts,
    the top 8 and K7's observed pass) on CUDA tensors, the twin on CPU
    tensors."""
    if m.pt_valid.device.type == "cpu":
        return fuse_candidates_torch(m, kf_id, n_local)
    obs, kp_valid = m.kf_obs_pt, m.kf_kp_valid
    cuda.require_cuda("fuse_candidates", obs, kp_valid, m.kf_valid,
                      m.pt_valid)
    K, F, N = m.K, m.F, m.N
    if (obs.dtype != torch.int32 or not 8 <= K <= 1024
            or not 0 <= kf_id < K):
        raise ValueError("fuse_candidates: expected int32 kf_obs_pt, 8 to "
                         "1024 keyframes and a slot below K")
    plan = compact_plan(N, n_local)
    ids = torch.empty((n_local,), dtype=torch.int32, device=obs.device)
    free = torch.empty((F,), dtype=torch.bool, device=obs.device)
    cuda.call("vsg_fuse_prologue", obs.data_ptr(), kp_valid.data_ptr(),
              m.kf_valid.data_ptr(), m.pt_valid.data_ptr(), K, F, N,
              int(kf_id), n_local, plan.wpt, ids.data_ptr(),
              free.data_ptr(), cuda.stream())
    fuse_candidates.launches += 1
    return ids, KeyframeKeypoints(m.kf_uv[kf_id], m.kf_desc[kf_id], free)


fuse_candidates.launches = 0


def fuse_writeback_torch(kf_obs_pt: torch.Tensor, kf_id: int,
                         ids: torch.Tensor, ok: torch.Tensor,
                         slot: torch.Tensor) -> torch.Tensor:
    """Plain twin of K28's write-back (see ``fuse_writeback``)."""
    if kf_obs_pt.is_cuda:
        fuse_writeback_torch.cuda_calls += 1
    F = kf_obs_pt.shape[1]
    # slot = max(match, 0): where(ok, slot, F - 1) is where(ok, match, F - 1)
    new_obs = kf_obs_pt[kf_id].scatter_reduce(
        0, torch.where(ok, slot, F - 1), torch.where(ok, ids, -1), "amax")
    out = kf_obs_pt.clone()
    out[kf_id] = new_obs
    return out


fuse_writeback_torch.cuda_calls = 0


def fuse_writeback(kf_obs_pt: torch.Tensor, kf_id: int, ids: torch.Tensor,
                   ok: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """A new ``kf_obs_pt`` whose row ``kf_id`` is the old row scatter-maxed
    with the matched candidates' ``ids`` at their keypoint ``slot``
    (unmatched entries max -1 into slot F - 1, as the reference).  One
    launch of kernel K28's write-back (``csrc/fuse_obs.cu``) on CUDA
    tensors, the twin on CPU tensors."""
    if kf_obs_pt.device.type == "cpu":
        return fuse_writeback_torch(kf_obs_pt, kf_id, ids, ok, slot)
    cuda.require_cuda("fuse_writeback", kf_obs_pt, ids, ok, slot)
    K, F = kf_obs_pt.shape
    n = ids.shape[0]
    if (kf_obs_pt.dtype != torch.int32 or ids.dtype != torch.int32
            or ok.dtype != torch.bool or slot.dtype != torch.int64
            or ok.shape != (n,) or slot.shape != (n,)
            or not 0 <= kf_id < K):
        raise ValueError("fuse_writeback: expected (K, F) int32 kf_obs_pt, "
                         "(n,) int32 ids, bool ok, int64 slots, a slot "
                         "below K")
    out = torch.empty_like(kf_obs_pt)
    cuda.call("vsg_fuse_writeback", kf_obs_pt.data_ptr(), K, F, int(kf_id),
              ok.data_ptr(), slot.data_ptr(), ids.data_ptr(), n,
              out.data_ptr(), cuda.stream())
    fuse_writeback.launches += 1
    return out


fuse_writeback.launches = 0


def fuse_observations(m: MapState, kf_id: int, cam_K: torch.Tensor,
                      n_local: int = 4096, radius: float = 4.0) -> MapState:
    """Link map points seen by covisible keyframes to this keyframe's
    unassociated keypoints (the observation-completing half of
    LocalMapping::SearchInNeighbors): the points of ``fuse_candidates``,
    projected at the keyframe's pose and window-matched against its free
    keypoints in one tracking pass (K5's redesign, without the image gate:
    the reference's projection + match_window), then ``fuse_writeback``'s
    scatter-max: three launches on the card (K28, K5, K28).
    ``fuse_observations.cuda_calls`` counts the calls on CUDA tensors (one
    tracking pass each)."""
    if m.pt_pos.is_cuda:
        fuse_observations.cuda_calls += 1
    ids, keypoints = fuse_candidates(m, kf_id, n_local)
    tp = track_pass(m.pt_pos, m.pt_desc, ids, m.kf_pose[kf_id], cam_K, None,
                    radius, keypoints, want_depth=False)
    return m._replace(kf_obs_pt=fuse_writeback(m.kf_obs_pt, kf_id, ids,
                                               tp.ok, tp.slot))


fuse_observations.cuda_calls = 0


def cull_keyframes(m: MapState, kf_id: int, redundancy: float = 0.9):
    """Retire the first covisible keyframe >90% of whose points are seen by
    >=3 other keyframes (KeyFrameCulling, LocalMapping.cc:898); keyframe 0
    and ``kf_id`` survive.  Returns (map, dropped slot or -1 as a device
    int32)."""
    nobs = point_obs_count(m)
    counts = covisibility_counts(m, kf_id)
    candidate = (counts > 0) & m.kf_valid
    candidate[0].fill_(False)
    candidate[kf_id].fill_(False)
    obs = m.kf_obs_pt
    safe = torch.clamp(obs, min=0).long()
    ok = m.kf_kp_valid & (obs >= 0) & m.pt_valid[safe]
    redundant_obs = ok & (nobs[safe] >= 4)
    n_obs_kf = ok.sum(1)
    n_red = redundant_obs.sum(1)
    ratio = n_red.to(torch.float32) / torch.clamp(n_obs_kf, min=1).to(
        torch.float32)
    drop = candidate & (ratio > redundancy) & (n_obs_kf > 0)
    first_drop = torch.argmax(drop.to(torch.int32))
    do = drop.any()
    m = retire_keyframe(m, first_drop, do)
    return m, torch.where(do, first_drop, -1).to(torch.int32)


def cull_points(m: MapState, min_obs: int = 2,
                min_found_ratio: float = 0.25) -> MapState:
    """Drop points observed by fewer than ``min_obs`` keyframes once they
    are 3 keyframes old, or recently created points whose found/visible
    ratio collapsed (MapPointCulling, LocalMapping.cc:341)."""
    nobs = point_obs_count(m)
    age = m.n_kf - m.pt_first_seq
    ratio = m.pt_found.to(torch.float32) / torch.clamp(
        m.pt_visible.to(torch.float32), min=1.0)
    low_ratio = (age <= 3) & (m.pt_visible >= 8) & (ratio < min_found_ratio)
    bad = m.pt_valid & (((age >= 3) & (nobs < min_obs)) | low_ratio)
    obs = m.kf_obs_pt
    linked_bad = (obs >= 0) & bad[torch.clamp(obs, min=0).long()]
    return m._replace(
        pt_valid=m.pt_valid & ~bad,
        pt_freed_seq=torch.where(bad, m.n_kf, m.pt_freed_seq),
        kf_obs_pt=torch.where(linked_bad, -1, obs),
    )


# the map fields K29 writes
CULL_FIELDS = ("kf_valid", "kf_obs_pt", "pt_valid", "pt_first_kf",
               "pt_freed_seq", "led_seq", "led_parent_seq", "led_T_cp",
               "led_n")


def cull_map_torch(m: MapState, kf_id: int, min_obs: int = 2,
                   min_found_ratio: float = 0.25, redundancy: float = 0.9):
    """Plain twin of K29: ``cull_points`` then ``cull_keyframes``."""
    if m.pt_valid.is_cuda:
        cull_map_torch.cuda_calls += 1
    m = cull_points(m, min_obs=min_obs, min_found_ratio=min_found_ratio)
    return cull_keyframes(m, kf_id, redundancy)


cull_map_torch.cuda_calls = 0


def cull_map(m: MapState, kf_id: int, min_obs: int = 2,
             min_found_ratio: float = 0.25, redundancy: float = 0.9):
    """``cull_points`` then ``cull_keyframes`` (the keyframe program's
    culls): returns (map, culled slot or -1 as a device int32).  One
    launch of kernel K29 (``csrc/map_cull.cu``, the changed fields written
    out of place) on CUDA tensors, the twin on CPU tensors."""
    if m.pt_valid.device.type == "cpu":
        return cull_map_torch(m, kf_id, min_obs, min_found_ratio, redundancy)
    cuda.require_cuda("cull_map", *m)
    K, F, N, E = m.K, m.F, m.N, m.E
    if (m.kf_obs_pt.dtype != torch.int32 or m.pt_found.dtype != torch.int32
            or not 0 <= kf_id < K or K > 1024):
        raise ValueError("cull_map: expected int32 tables, at most 1024 "
                         "keyframes and a slot below K")
    if cuda.query("vsg_map_cull_smem", K, N) > cuda.SMEM_LIMIT:
        raise ValueError(f"cull_map: {N} points exceed the kernel's shared "
                         "memory")
    new = m._replace(**{f: torch.empty_like(getattr(m, f))
                        for f in CULL_FIELDS})
    out = [getattr(new, f) if f in CULL_FIELDS else None
           for f in MapState._fields]
    culled = torch.empty((), dtype=torch.int32, device=m.pt_valid.device)
    cuda.call("vsg_map_cull", cuda.ptr_array(list(m)), cuda.ptr_array(out),
              K, F, N, E, int(kf_id), int(min_obs), float(min_found_ratio),
              float(redundancy), culled.data_ptr(), cuda.stream())
    cull_map.launches += 1
    return new, culled


cull_map.launches = 0


CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def lba_slots(m: MapState, kf_id: int, n_window: int):
    """(kf_ids, kf_mask): ``kf_id`` and its top ``n_window`` covisible
    keyframes (lax.top_k's tie order)."""
    dev = m.kf_pose.device
    top_counts, top_kfs = topk_stable(covisibility_counts(m, kf_id),
                                      n_window)
    kf_ids = torch.cat([torch.full((1,), kf_id, device=dev), top_kfs])
    kf_mask = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         top_counts > 0]) & m.kf_valid[kf_ids]
    return kf_ids, kf_mask


def lba_window(m: MapState, kf_id: int, cam_K, cam_bf, n_window: int,
               n_local_pts: int):
    """The visual part of the generic windowed BA: ``kf_id`` and its top
    ``n_window`` covisible keyframes (lax.top_k's tie order), the points
    they observe (compacted, ascending), and the mono / stereo
    reprojection batches over every (window keyframe, keypoint) pair.
    Returns (kf_ids, kf_mask, safe_pt, pt_ok, batches)."""
    kf_ids, kf_mask = lba_slots(m, kf_id, n_window)
    safe_pt, pt_ok, rows = window_rows(m, kf_ids, kf_mask, cam_bf,
                                       n_local_pts)
    return (kf_ids, kf_mask, safe_pt, pt_ok,
            reproj_batches(rows, cam_K, cam_bf))


def window_rows(m: MapState, kf_ids, kf_mask, cam_bf, n_local_pts: int):
    """The points the keyframes ``kf_ids`` (masked by ``kf_mask``) observe
    (compacted, ascending: kernel K7) and the reprojection rows over every
    (window keyframe, keypoint) pair: a stereo (u, v, u_r) row where the
    keypoint has depth and ``cam_bf`` is given, else a mono (u, v) row.
    Returns (safe_pt, pt_ok, ``lm_kernels.ReprojRows``)."""
    dev = m.kf_pose.device
    L = kf_ids.shape[0]
    obs = m.kf_obs_pt[kf_ids]
    obs_safe = torch.clamp(obs, min=0).long()
    obs_ok = (m.kf_kp_valid[kf_ids] & kf_mask[:, None] & (obs >= 0)
              & m.pt_valid[obs_safe])
    local_pt = compact_observed(m, kf_ids, kf_mask, n_local_pts)
    pt_ok = local_pt >= 0
    safe_pt = torch.clamp(local_pt, min=0)
    inv = torch.full((m.N + 1,), -1, dtype=torch.int32, device=dev)
    index_set_last(inv, safe_pt + 1, torch.where(
        pt_ok, torch.arange(n_local_pts, dtype=torch.int32, device=dev), -1))
    pt_local_idx = inv[obs_safe + 1]
    use = (obs_ok & (pt_local_idx >= 0)).reshape(-1)
    kf_rows = torch.arange(L, dtype=torch.int32, device=dev)[:, None].expand(
        obs.shape)
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    if cam_bf is None:
        stereo = torch.zeros_like(use)
        ur = torch.zeros_like(uv[:, :1])
    else:
        stereo = depth > 0
        ur = uv[:, :1] - cam_bf / torch.clamp(depth, min=1e-3)[:, None]
    rows = lmk.ReprojRows(
        slot=kf_rows.reshape(-1).contiguous(),
        pt=torch.clamp(pt_local_idx, min=0).reshape(-1).to(torch.int32),
        uvr=torch.cat([uv, ur], dim=1), use=use, stereo=stereo)
    return safe_pt, pt_ok, rows


def reproj_batches(rows, cam_K, cam_bf) -> list:
    """The mono / stereo reprojection ``FactorBatch``es of ``rows`` for
    the generic LM engine."""
    mtot = rows.slot.shape[0]
    var_idx = torch.stack([rows.slot, rows.pt], dim=1)
    ones = torch.ones((mtot,), dtype=torch.float32, device=rows.slot.device)
    cam = cam_K.expand(mtot, 4)
    batches = [FactorBatch(("kf", "pt"), factors.reproj_mono, 2, var_idx,
                           {"uv": rows.uvr[:, :2], "cam": cam}, ones,
                           rows.use & ~rows.stereo,
                           huber=math.sqrt(CHI2_MONO))]
    if cam_bf is not None:
        batches.append(FactorBatch(
            ("kf", "pt"), factors.reproj_stereo, 3, var_idx,
            {"uv_ur": rows.uvr, "cam": cam, "bf": cam_bf.expand(mtot)}, ones,
            rows.use & rows.stereo, huber=math.sqrt(CHI2_STEREO)))
    return batches


def lba_gauge(m: MapState, kf_ids, kf_mask, monocular: bool):
    """Fixed window keyframes: invalid rows, the oldest valid one (lowest
    slot) and keyframe 0; with no depth also the second oldest, whose
    baseline pins the scale (Optimizer.cc:1741-1757)."""
    min_id = torch.min(torch.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    if monocular:
        min2_id = torch.min(torch.where(kf_mask & (kf_ids != min_id),
                                        kf_ids, m.K))
        kf_fixed = kf_fixed | (kf_ids == min2_id)
    return kf_fixed


def write_window(m: MapState, kf_ids, kf_mask, kf_pose, safe_pt, pt_ok,
                 pt_pos) -> MapState:
    """Write a window's solved poses and points back into the map."""
    new_kf_pose = index_set_last(
        m.kf_pose.clone(), kf_ids,
        torch.where(kf_mask[:, None], kf_pose, m.kf_pose[kf_ids]))
    new_pt_pos = index_set_last(
        m.pt_pos.clone(), safe_pt,
        torch.where(pt_ok[:, None], pt_pos, m.pt_pos[safe_pt]))
    return m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos)


def lba_problem(m: MapState, kf_id: int, cam_K, cam_bf, n_window: int,
                n_local_pts: int):
    """The generic windowed BA's problem: (kf_ids, kf_mask, safe_pt, pt_ok,
    the keyword arguments of ``lm_kernels.optimize_reproj_inertial`` but
    ``iters``)."""
    kf_ids, kf_mask = lba_slots(m, kf_id, n_window)
    safe_pt, pt_ok, rows = window_rows(m, kf_ids, kf_mask, cam_bf,
                                       n_local_pts)
    kf_fixed = lba_gauge(m, kf_ids, kf_mask, cam_bf is None)
    red = lmk.Reduced(pose=m.kf_pose[kf_ids])
    return kf_ids, kf_mask, safe_pt, pt_ok, dict(
        red=red, free=lmk.free_mask(red, {"pose": kf_fixed}),
        pts=m.pt_pos[safe_pt], pt_fixed=~pt_ok, rows=rows, cam=cam_K,
        bf=cam_bf)


def local_ba(m: MapState, kf_id: int, cam_K, cam_bf=None,
             n_window: int = 10, n_local_pts: int = 8192, iters: int = 10):
    """Windowed BA over the covisibility neighbourhood of ``kf_id``
    (Optimizer::LocalBundleAdjustment, Optimizer.cc:1454): stereo (u, v,
    u_r) rows for keypoints with depth, mono rows for the rest, points
    eliminated by the Schur complement, on the LM engine's kernel route
    (``optim/lm_kernels.py``: K22a, K22c).  Returns (map, final cost as a
    device scalar)."""
    kf_ids, kf_mask, safe_pt, pt_ok, problem = lba_problem(
        m, kf_id, cam_K, cam_bf, n_window, n_local_pts)
    res = lmk.optimize_reproj_inertial(iters=iters, **problem)
    return write_window(m, kf_ids, kf_mask, res.red.pose, safe_pt, pt_ok,
                        res.pts), res.cost
