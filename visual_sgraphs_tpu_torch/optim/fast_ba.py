"""Analytic windowed bundle adjustment — the keyframe path's local BA.

Port of ``fast_local_ba`` from ``visual_sgraphs_tpu/optim/fast_ba.py``
(Optimizer::LocalBundleAdjustment, Optimizer.cc:1454): the reference
keyframe plus its ``n_window`` most covisible keyframes and every valid
point they observe; the oldest local keyframe (and keyframe 0) is the
gauge anchor.  Each Gauss-Newton iteration reduces the landmarks with the
Schur core of ``parallel/dist_ba.py``, solves the damped (6L, 6L) camera
system by Cholesky and back-substitutes the points.  The scene-graph
variant (``fast_scenegraph_ba``) is not ported yet.
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.parallel.dist_ba import (
    _back_substitute,
    _local_reduced_system,
    group_observations,
)
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    compact_true,
    covisibility_counts,
    index_set_last,
    observed_mask,
)
from visual_sgraphs_tpu_torch.slam.tracking import topk_stable


def fast_local_ba(m: MapState, kf_id: int, cam_K: torch.Tensor,
                  cam_bf: torch.Tensor | None = None, n_window: int = 10,
                  n_local_pts: int = 8192, max_obs: int = 12,
                  iters: int = 10, lam: float = 1e-4):
    """Analytic windowed BA (reprojection + RGB-D disparity rows).
    Returns (map, final cost as a device scalar)."""
    dev = m.kf_pose.device
    counts = covisibility_counts(m, kf_id)
    top_counts, top_kfs = topk_stable(counts, n_window)
    kf_ids = torch.cat([torch.full((1,), kf_id, device=dev), top_kfs])
    kf_mask = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         top_counts > 0]) & m.kf_valid[kf_ids]
    L = kf_ids.shape[0]

    obs = m.kf_obs_pt[kf_ids]
    obs_safe = torch.clamp(obs, min=0).long()
    obs_ok = (m.kf_kp_valid[kf_ids] & kf_mask[:, None] & (obs >= 0)
              & m.pt_valid[obs_safe])
    local_pt = compact_true(observed_mask(m, kf_ids, kf_mask) & m.pt_valid,
                            n_local_pts)
    pt_ok = local_pt >= 0
    safe_pt = torch.clamp(local_pt, min=0)
    inv = torch.full((m.N + 1,), -1, dtype=torch.int32, device=dev)
    index_set_last(inv, safe_pt + 1, torch.where(
        pt_ok, torch.arange(n_local_pts, dtype=torch.int32, device=dev), -1))
    pt_local_idx = inv[obs_safe + 1]
    use = obs_ok & (pt_local_idx >= 0)

    kf_rows = torch.arange(L, dtype=torch.int32, device=dev)[:, None].expand(
        obs.shape)
    uv = m.kf_uv[kf_ids].reshape(-1, 2)
    depth = m.kf_depth[kf_ids].reshape(-1)
    if cam_bf is None:
        bf = torch.zeros((), dtype=torch.float32, device=dev)
        ur = torch.full_like(depth, -1.0)
    else:
        bf = cam_bf
        ur = torch.where(depth > 0,
                         uv[:, 0] - bf / torch.clamp(depth, min=1e-3), -1.0)
    uvr = torch.cat([uv, ur[:, None]], dim=1)
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        kf_rows.reshape(-1), pt_local_idx.reshape(-1), uvr,
        use.reshape(-1), n_local_pts, max_obs)

    min_id = torch.min(torch.where(kf_mask, kf_ids, m.K))
    kf_fixed = (~kf_mask) | (kf_ids == min_id) | (kf_ids == 0)
    if cam_bf is None:
        min2_id = torch.min(torch.where(kf_mask & (kf_ids != min_id),
                                        kf_ids, m.K))
        kf_fixed = kf_fixed | (kf_ids == min2_id)

    poses = m.kf_pose[kf_ids]
    pts = m.pt_pos[safe_pt]
    free = (~kf_fixed).repeat_interleave(6).to(torch.float32)
    cost = None
    for _ in range(iters):
        S, rhs, Hinv, bx, W, cost = _local_reduced_system(
            poses, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, 2.45)
        diag = torch.clamp(torch.diagonal(S), min=1e-6)
        S = S + torch.diag(lam * diag + 1e-5)
        S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        rhs = rhs * free
        # cholesky_ex: no host-side error check (no sync); a failed
        # factorisation shows up as non-finite steps, zeroed below
        chol, _ = torch.linalg.cholesky_ex(S)
        dxr = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
        dxr = torch.where(torch.isfinite(dxr), dxr, 0.0) * free
        dxr6 = dxr.reshape(L, 6)
        new_poses = lie.se3_normalize(lie.se3_boxplus(
            poses, torch.where(kf_fixed[:, None], 0.0, dxr6)))
        dxe = _back_substitute(Hinv, bx, W, kf_tab, val_tab, dxr6)
        pts = pts + torch.where(pt_ok[:, None], dxe, 0.0)
        poses = new_poses
    new_kf_pose = index_set_last(
        m.kf_pose.clone(), kf_ids,
        torch.where((kf_mask & ~kf_fixed)[:, None], poses, m.kf_pose[kf_ids]))
    new_pt_pos = index_set_last(
        m.pt_pos.clone(), safe_pt,
        torch.where(pt_ok[:, None], pts, m.pt_pos[safe_pt]))
    return m._replace(kf_pose=new_kf_pose, pt_pos=new_pt_pos), cost
