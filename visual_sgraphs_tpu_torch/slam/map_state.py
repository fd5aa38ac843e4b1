"""The map as a NamedTuple of fixed-capacity tensors.

Port of ``visual_sgraphs_tpu/slam/map_state.py``: the same field names,
shapes and dtypes, so a reference map converts field for field
(``interop.map_from_numpy``).  Keyframes own per-slot keypoint tables;
``kf_obs_pt`` is the primary keyframe -> point association, from which
covisibility is derived on demand by batched reductions.
``compact_true`` and ``compact_observed`` are kernel K7 (sync-free
fixed-size compaction; the second builds its observed-point mask in the
same launch).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.config import CapacityConfig, OrbConfig


class MapState(NamedTuple):
    """Fixed-capacity SLAM map (see the reference for field semantics)."""

    kf_pose: torch.Tensor  # (K, 7) T_cw
    kf_valid: torch.Tensor  # (K,) bool
    kf_timestamp: torch.Tensor  # (K,)
    kf_uv: torch.Tensor  # (K, F, 2)
    kf_depth: torch.Tensor  # (K, F) metric depth (<=0: unknown)
    kf_level: torch.Tensor  # (K, F) int32
    kf_angle: torch.Tensor  # (K, F)
    kf_desc: torch.Tensor  # (K, F, 32) uint8
    kf_kp_valid: torch.Tensor  # (K, F) bool
    kf_obs_pt: torch.Tensor  # (K, F) int32 map-point id or -1
    kf_seq: torch.Tensor  # (K,) int32 insertion sequence (-1 invalid)
    pt_pos: torch.Tensor  # (N, 3) world
    pt_valid: torch.Tensor  # (N,) bool
    pt_desc: torch.Tensor  # (N, 32) uint8
    pt_first_kf: torch.Tensor  # (N,) creating keyframe slot
    pt_first_seq: torch.Tensor  # (N,) creating keyframe sequence
    pt_freed_seq: torch.Tensor  # (N,) n_kf when culled (reuse quarantine)
    pt_visible: torch.Tensor  # (N,) int32
    pt_found: torch.Tensor  # (N,) int32
    led_seq: torch.Tensor  # (E,) retired keyframe's sequence number
    led_parent_seq: torch.Tensor  # (E,) surviving parent's sequence
    led_T_cp: torch.Tensor  # (E, 7) T_retired_cw . T_parent_cw^-1
    led_n: torch.Tensor  # () int32 ledger length
    n_kf: torch.Tensor  # () int32
    n_pt: torch.Tensor  # () int32

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def F(self) -> int:
        return self.kf_uv.shape[1]

    @property
    def N(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def E(self) -> int:
        return self.led_seq.shape[0]


def empty_map(cap: CapacityConfig = CapacityConfig(),
              orb: OrbConfig = OrbConfig(),
              device: torch.device | str | None = None) -> MapState:
    K, F, N = cap.max_keyframes, orb.n_features, cap.max_points
    E = cap.max_retired
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    kf_pose = full((K, 7), 0.0, f32)
    kf_pose[:, 0] = 1.0
    led_T_cp = full((E, 7), 0.0, f32)
    led_T_cp[:, 0] = 1.0
    return MapState(
        kf_pose=kf_pose,
        kf_valid=full((K,), False, torch.bool),
        kf_timestamp=full((K,), 0.0, f32),
        kf_uv=full((K, F, 2), 0.0, f32),
        kf_depth=full((K, F), -1.0, f32),
        kf_level=full((K, F), 0, i32),
        kf_angle=full((K, F), 0.0, f32),
        kf_desc=full((K, F, 32), 0, torch.uint8),
        kf_kp_valid=full((K, F), False, torch.bool),
        kf_obs_pt=full((K, F), -1, i32),
        kf_seq=full((K,), -1, i32),
        pt_pos=full((N, 3), 0.0, f32),
        pt_valid=full((N,), False, torch.bool),
        pt_desc=full((N, 32), 0, torch.uint8),
        pt_first_kf=full((N,), -1, i32),
        pt_first_seq=full((N,), -1, i32),
        pt_freed_seq=full((N,), -(10**6), i32),
        pt_visible=full((N,), 0, i32),
        pt_found=full((N,), 0, i32),
        led_seq=full((E,), -1, i32),
        led_parent_seq=full((E,), -1, i32),
        led_T_cp=led_T_cp,
        led_n=full((), 0, i32),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
    )


def compact_true_torch(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Plain twin of K7: indices of the first ``size`` True entries of 1-D
    ``mask`` in ascending order, padded with -1 (cumsum + scatter; no
    device-to-host sync)."""
    if mask.is_cuda:
        compact_true_torch.cuda_calls += 1
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (pos < size)
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    # rows that are not kept all land in the dump slot ``size``
    out.scatter_(0, torch.where(keep, pos, size),
                 torch.arange(n, device=mask.device))
    return out[:size]


compact_true_torch.cuda_calls = 0


# K7's launch plan (csrc/compact.cu): one CTA of COMPACT_THREADS threads,
# each owning ``wpt`` consecutive 32-entry words of the mask, ``wpt`` one of
# COMPACT_WPT (the kernel's instantiations); in shared memory the staged
# ids (4 bytes a slot of the output) and, for the observed entry, the
# membership bitmap of the N points before them (4 bytes a word)
COMPACT_THREADS = 1024
COMPACT_WPT = (1, 2, 4, 8, 16, 32, 64)


class CompactPlan(NamedTuple):
    words: int  # 32-entry words covering the mask
    wpt: int  # words a thread
    smem_true: int  # the plain entry's shared bytes: the staged ids
    smem_observed: int  # the observed entry's: the bitmap, the staged ids


@functools.lru_cache(maxsize=64)
def compact_plan(n: int, size: int) -> CompactPlan:
    """K7's words a thread and shared-memory bytes for a mask of ``n``
    entries compacted to ``size`` ids; raises when the observed entry's
    bitmap and staged ids exceed a CTA's shared memory (n + 32 size <
    ~1.86M)."""
    words = -(-n // 32)
    smem = 4 * (words + size)
    if smem > cuda.SMEM_LIMIT:
        raise ValueError(f"compact: {n} entries and {size} ids exceed the "
                         "kernel's shared memory")
    wpt = next(w for w in COMPACT_WPT if w * COMPACT_THREADS >= words)
    return CompactPlan(words=words, wpt=wpt, smem_true=4 * size,
                       smem_observed=smem)


def compact_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=-1)`` without a
    device-to-host sync: (size,) int64 indices of the first ``size`` True
    entries of 1-D bool ``mask``, ascending, -1 padded.  Kernel K7
    (``csrc/compact.cu``, one launch) on CUDA tensors, the plain twin on
    CPU tensors."""
    if mask.device.type == "cpu":
        return compact_true_torch(mask, size)
    cuda.require_cuda("compact_true", mask)
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("compact_true: expected a 1-D bool mask")
    plan = compact_plan(mask.shape[0], size)
    out = torch.empty((size,), dtype=torch.int64, device=mask.device)
    if size:
        cuda.call("vsg_compact", mask.data_ptr(), mask.shape[0], size,
                  plan.wpt, plan.smem_true, out.data_ptr(), cuda.stream())
        compact_true.launches += 1
    return out


compact_true.launches = 0


def compact_observed_torch(m: MapState, kf_ids: torch.Tensor,
                           kf_mask: torch.Tensor, size: int,
                           dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Plain twin of K7's observed entry: ``compact_true(observed_mask(m,
    kf_ids, kf_mask) & m.pt_valid, size)``, cast to ``dtype``."""
    if m.pt_valid.is_cuda:
        compact_observed_torch.cuda_calls += 1
    return compact_true_torch(observed_mask(m, kf_ids, kf_mask) & m.pt_valid,
                              size).to(dtype)


compact_observed_torch.cuda_calls = 0


def compact_observed(m: MapState, kf_ids: torch.Tensor,
                     kf_mask: torch.Tensor, size: int,
                     dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """(size,) ids of the first ``size`` valid map points that any of the
    keyframes ``kf_ids`` (masked by ``kf_mask``) observes, ascending, -1
    padded, int64 (or ``dtype`` int32): ``compact_observed_torch``'s
    composition as one launch of K7's observed entry on CUDA tensors (the
    membership bitmap built in the launch; no host read), the twin on CPU
    tensors."""
    if m.pt_valid.device.type == "cpu":
        return compact_observed_torch(m, kf_ids, kf_mask, size, dtype)
    obs, kp_valid, pt_valid = m.kf_obs_pt, m.kf_kp_valid, m.pt_valid
    cuda.require_cuda("compact_observed", obs, kp_valid, kf_ids, kf_mask,
                      pt_valid)
    if (obs.dtype != torch.int32 or kp_valid.dtype != torch.bool
            or obs.shape != kp_valid.shape or obs.dim() != 2
            or kf_ids.dtype != torch.int64 or kf_mask.dtype != torch.bool
            or pt_valid.dtype != torch.bool or kf_ids.dim() != 1
            or kf_mask.shape != kf_ids.shape
            or dtype not in (torch.int64, torch.int32)):
        raise ValueError("compact_observed: expected (K, F) int32 "
                         "observations and bool flags, (L,) int64 keyframe "
                         "ids and a bool mask, (N,) bool pt_valid, int64 or "
                         "int32 ids")
    K, F = obs.shape
    n = pt_valid.shape[0]
    plan = compact_plan(n, size)
    out = torch.empty((size,), dtype=dtype, device=pt_valid.device)
    if size:
        cuda.call("vsg_compact_observed", obs.data_ptr(), kp_valid.data_ptr(),
                  K, F, kf_ids.data_ptr(), kf_mask.data_ptr(),
                  kf_ids.shape[0], pt_valid.data_ptr(), n, size, plan.wpt,
                  plan.smem_observed, int(dtype == torch.int32),
                  out.data_ptr(), cuda.stream())
        compact_observed.launches += 1
    return out


compact_observed.launches = 0


def index_set_last(dst: torch.Tensor, idx: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(src)`` with XLA's duplicate order: updates apply
    in sequence, so for a repeated index the LAST entry wins.  Every entry
    writes its index's winning value, so the in-place scatter is
    deterministic.  Returns ``dst`` (updated in place)."""
    n = idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    last = torch.full((dst.shape[0],), -1, dtype=torch.int64,
                      device=idx.device)
    last.scatter_reduce_(0, idx, pos, "amax")
    dst[idx] = src[last[idx]]
    return dst


def point_obs_count(m: MapState) -> torch.Tensor:
    """(N,) number of keyframe observations per map point."""
    obs = torch.where(m.kf_kp_valid & m.kf_valid[:, None], m.kf_obs_pt, -1)
    flat = torch.clamp(obs.reshape(-1), -1, m.N - 1).long() + 1
    counts = torch.zeros((m.N + 1,), dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[1:]


def _member_of(obs_flat: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) bool membership of point ids (-1 -> slot 0)."""
    member = torch.zeros((n + 1,), dtype=torch.bool, device=obs_flat.device)
    return member.index_fill_(0, obs_flat.long() + 1, True)


def covisibility_counts(m: MapState, kf_id) -> torch.Tensor:
    """(K,) number of valid map points shared between keyframe ``kf_id``
    and every keyframe (KeyFrame::UpdateConnections)."""
    obs_k = m.kf_obs_pt[kf_id]
    member = _member_of(torch.where(m.kf_kp_valid[kf_id], obs_k, -1), m.N)
    member[0].fill_(False)
    member[1:] &= m.pt_valid
    shared = member[torch.where(m.kf_kp_valid, m.kf_obs_pt, -1).long() + 1]
    counts = torch.sum(shared, dim=1).to(torch.int32)
    counts = torch.where(m.kf_valid, counts, 0)
    counts[kf_id].fill_(0)
    return counts


def observed_mask(m: MapState, kf_ids: torch.Tensor,
                  kf_mask: torch.Tensor) -> torch.Tensor:
    """(N,) bool — map points observed by any of ``kf_ids`` (masked).  The
    main path compacts it with ``compact_observed`` (K7's observed entry)
    and never builds it on the card: ``observed_mask.cuda_calls`` counts
    the calls on CUDA tensors."""
    if kf_ids.is_cuda:
        observed_mask.cuda_calls += 1
    obs = m.kf_obs_pt[kf_ids]
    ok = m.kf_kp_valid[kf_ids] & kf_mask[:, None]
    flat = torch.where(ok, obs, -1).reshape(-1)
    return _member_of(flat, m.N)[1:]


observed_mask.cuda_calls = 0
