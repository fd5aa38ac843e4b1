"""Tracking: local-map matching + motion-only pose solve (kernel K6, and
its pose-prior branch on the inertial path), and the scan's per-frame
bookkeeping (kernel K25).

Port of ``visual_sgraphs_tpu/slam/tracking.py`` (Tracking::Track's
TrackWithMotionModel / TrackLocalMap / PoseOptimization): gather the local
map of the reference keyframe's covisibility neighbourhood, project and
window-match it against the frame's keypoints at the predicted pose (the
tracking pass, ``features.match.track_pass``: K5's redesign, one launch
with the gathers the solve takes), solve the pose (kernel K6), then
re-match tighter at the refined pose and solve again.  When too few
inliers survive, the same two passes re-run from the last good pose with
4x / 2x windows.

The reference decides that retry on the device (``lax.cond``).  On the
serial path (``make_frame_step``) the port runs eagerly, so it reads the
first attempt's three counters back to the host (one readback per frame)
and decides there; the same host copy then serves the keyframe policy, so
no second readback is needed.  The B-frame scan (``make_frame_scan``) must
not sync the host inside a batch: it runs the wide-window retry for every
frame, and one K25 launch a frame keeps it where the first attempt fell
short, which gives the reference's results exactly.  Each attempt's
inlier tail (the kept ids by keypoint slot, their count) is K25 too: its
tail entry on the serial path, inside the frame's launch on the scan.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.features.match import track_pass
from visual_sgraphs_tpu_torch.slam.frame import (
    FrameObs,
    frame_at,
    make_frame_obs,
)
from visual_sgraphs_tpu_torch.slam.map_state import (
    MapState,
    compact_observed,
    covisibility_counts,
)

CHI2_MONO = 5.991


class TrackResult(NamedTuple):
    pose: torch.Tensor  # (7,) optimized T_cw
    slot_pt: torch.Tensor  # (F,) int32 map-point id per frame keypoint, -1
    vis_pt: torch.Tensor  # (n_local,) int32 point ids predicted visible, -1
    n_matches: torch.Tensor  # () int32 matches fed to the solver
    n_inliers: torch.Tensor  # () int32 inliers after gating
    n_local_pts: torch.Tensor  # () int32 size of the local map used


def topk_stable(x: torch.Tensor, k: int):
    """1-D top-k with lax.top_k's tie order (lower index first)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class LocalTable(NamedTuple):
    ids: torch.Tensor  # (n_local,) int32 point ids, ascending, -1 padded
    valid: torch.Tensor  # (n_local,) bool ids >= 0
    xw: torch.Tensor  # (n_local, 3) float32 their positions (point 0's pad)
    n_pts: torch.Tensor  # () int32 real ids


def _local_point_table(m: MapState, ref_kf: int, n_window: int,
                       n_local: int) -> LocalTable:
    """Compact table of the points seen by the covisibility neighbourhood
    of ``ref_kf`` (UpdateLocalKeyFrames/Points, Tracking.cc:3536/3507),
    with their positions and count."""
    counts = covisibility_counts(m, ref_kf)
    top_counts, top_kfs = topk_stable(counts, n_window)
    dev = counts.device
    kf_ids = torch.cat([torch.full((1,), ref_kf, device=dev), top_kfs])
    kf_mask = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         top_counts > 0]) & m.kf_valid[kf_ids]
    ids = compact_observed(m, kf_ids, kf_mask, n_local, torch.int32)
    valid = ids >= 0
    return LocalTable(ids=ids, valid=valid,
                      xw=m.pt_pos[torch.clamp(ids, min=0)].contiguous(),
                      n_pts=valid.sum(dtype=torch.int32))


def _gate_schedule(iters: int, chi2_gate: float, gate0):
    final_gate = chi2_gate * 4.0
    if gate0 is None or gate0 < final_gate:
        gate0 = final_gate
    n_wide = max(iters // 4, 1) if gate0 > final_gate else 0
    return n_wide, float(np.float32(gate0)), float(np.float32(final_gate))


def _pose_only_gn_plain(T_init, xw, uv, valid, cam_K, iters, chi2_gate,
                        huber, gate0, depth, bf, T_prior, prior_weight):
    """The reference's pose_only_gn, step for step."""
    fx, fy = cam_K[0], cam_K[1]
    M = xw.shape[0]
    n_wide, g0, gf = _gate_schedule(iters, chi2_gate, gate0)
    use_stereo = depth is not None and bf is not None
    if use_stereo:
        has_d = valid & (depth > 0)
        ur_obs = uv[:, 0] - bf / torch.where(has_d, depth, 1.0)
        w_ur = torch.clamp((2.5 / torch.clamp(depth, min=0.1)) ** 2, max=1.0)
    eye3 = torch.eye(3, dtype=xw.dtype, device=xw.device).expand(M, 3, 3)
    T = T_init
    for it in range(iters):
        gate = g0 if it < n_wide else gf
        R = lie.quat_to_matrix(T[:4])
        p = xw @ R.T + T[4:7]
        z = torch.clamp(p[:, 2], min=1e-6)
        inv_z = 1.0 / z
        u_hat = fx * p[:, 0] * inv_z + cam_K[2]
        v_hat = fy * p[:, 1] * inv_z + cam_K[3]
        res = [u_hat - uv[:, 0], v_hat - uv[:, 1]]
        if use_stereo:
            ur_hat = u_hat - bf * inv_z
            res.append(torch.where(has_d, (ur_hat - ur_obs) * w_ur, 0.0))
        r = torch.stack(res, dim=1)
        chi2 = torch.sum(r * r, dim=1)
        ok = valid & (p[:, 2] > 0.05)
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(ok & (chi2 <= gate),
                        torch.clamp(huber / s, max=1.0), 0.0)
        zero = torch.zeros_like(z)
        rows = [
            torch.stack([fx * inv_z, zero, -fx * p[:, 0] * inv_z * inv_z], 1),
            torch.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], 1),
        ]
        if use_stereo:
            rows.append(torch.stack([
                fx * inv_z, zero, (-fx * p[:, 0] + bf) * inv_z * inv_z,
            ], 1) * (has_d * w_ur)[:, None])
        Jp = torch.stack(rows, dim=1)
        R_dim = Jp.shape[1]
        Jx = torch.cat([eye3, -lie.hat(p)], dim=2)
        J = torch.einsum("mij,mjk->mik", Jp, Jx)
        Jw = J * w[:, None, None]
        H = Jw.reshape(M * R_dim, 6).T @ J.reshape(M * R_dim, 6)
        g = torch.einsum("mri,mr->i", Jw, r)
        if T_prior is not None and prior_weight > 0.0:
            r_p = lie.se3_log(lie.se3_multiply(T, lie.se3_inverse(T_prior)))
            H = H + torch.eye(6, dtype=H.dtype, device=H.device) * prior_weight
            g = g + prior_weight * r_p
        H = H + torch.eye(6, dtype=H.dtype, device=H.device) * 1e-3
        dx = torch.linalg.solve_ex(H, -g)[0]
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        T = lie.se3_normalize(lie.se3_boxplus(T, dx))
    p = lie.se3_apply(T, xw)
    uv_hat = cameras.project_pinhole(cam_K, p)
    chi2 = torch.sum((uv_hat - uv) ** 2, dim=1)
    inl = valid & (p[:, 2] > 0.05) & (chi2 <= chi2_gate)
    return T, inl


def pose_only_gn_torch(T_init, xw, uv, valid, cam_K, iters: int = 10,
                       chi2_gate: float = CHI2_MONO, huber: float = 2.447,
                       gate0: float | None = None, depth=None, bf=None):
    """Plain PyTorch twin of K6 (the reference's pose_only_gn, step for
    step).  Returns (T (7,), inliers (M,) bool)."""
    if xw.is_cuda:
        pose_only_gn_torch.cuda_calls += 1
    return _pose_only_gn_plain(T_init, xw, uv, valid, cam_K, iters,
                               chi2_gate, huber, gate0, depth, bf, None, 0.0)


pose_only_gn_torch.cuda_calls = 0


def pose_only_gn_prior_torch(T_init, xw, uv, valid, cam_K, T_prior,
                             prior_weight: float, iters: int = 10,
                             chi2_gate: float = CHI2_MONO,
                             huber: float = 2.447,
                             gate0: float | None = None, depth=None,
                             bf=None):
    """Plain twin of K6's prior branch."""
    if xw.is_cuda:
        pose_only_gn_prior_torch.cuda_calls += 1
    return _pose_only_gn_plain(T_init, xw, uv, valid, cam_K, iters,
                               chi2_gate, huber, gate0, depth, bf, T_prior,
                               prior_weight)


pose_only_gn_prior_torch.cuda_calls = 0


# K6's launch plan (csrc/pose_gn.cu): POSE_GN_MATCHES matches a CTA of 256
# threads before a solve takes another CTA, up to POSE_GN_CLUSTER (the
# portable cluster size); a CTA holds its share of the matches in shared
# memory (POSE_GN_BYTES a match), within cuda.SMEM_LIMIT less the
# kernel's static POSE_GN_STATIC bytes
POSE_GN_MATCHES = 512
POSE_GN_CLUSTER = 8
POSE_GN_BYTES = 29  # xw (12), uv (8), stereo row (8), flags (1)
POSE_GN_STATIC = 4096


class PoseGnPlan(NamedTuple):
    cluster: int  # CTAs
    chunk: int  # matches a CTA
    smem: int  # dynamic shared-memory bytes a CTA


def pose_gn_plan(M: int) -> PoseGnPlan:
    """K6's cluster for M matches: one CTA up to POSE_GN_MATCHES, one more
    for each further POSE_GN_MATCHES up to POSE_GN_CLUSTER; raises when a
    CTA's share would not fit its shared memory."""
    cluster = min(POSE_GN_CLUSTER, max(1, -(-M // POSE_GN_MATCHES)))
    chunk = -(-M // cluster)
    smem = -(-POSE_GN_BYTES * chunk // 16) * 16
    if smem > cuda.SMEM_LIMIT - POSE_GN_STATIC:
        raise ValueError(f"pose_only_gn: {M} matches exceed the kernel's "
                         "shared memory")
    return PoseGnPlan(cluster=cluster, chunk=chunk, smem=smem)


def _launch_pose_gn(T_init, xw, uv, valid, cam_K, iters, chi2_gate, huber,
                    gate0, depth, bf, T_prior, prior_weight):
    use_stereo = depth is not None and bf is not None
    tensors = [T_init, xw, uv, valid, cam_K] + (
        [depth, bf] if use_stereo else []) + (
        [T_prior] if T_prior is not None else [])
    cuda.require_cuda("pose_only_gn", *tensors)
    if any(t.dtype != torch.float32 for t in tensors if t is not valid) \
            or valid.dtype != torch.bool:
        raise ValueError("pose_only_gn: expected float32 tensors + bool mask")
    n_wide, g0, gf = _gate_schedule(iters, chi2_gate, gate0)
    M = xw.shape[0]
    plan = pose_gn_plan(M)
    T_out = torch.empty((7,), dtype=torch.float32, device=xw.device)
    inliers = torch.empty((M,), dtype=torch.bool, device=xw.device)
    cuda.call("vsg_pose_gn", cuda.ptr(T_init), cuda.ptr(xw), cuda.ptr(uv),
              cuda.ptr(valid), cuda.ptr(cam_K),
              cuda.ptr(depth) if use_stereo else None,
              cuda.ptr(bf) if use_stereo else None, M, plan.cluster,
              plan.chunk, plan.smem, iters, n_wide, g0, gf,
              float(np.float32(huber)), float(np.float32(chi2_gate)),
              cuda.ptr(T_prior), float(np.float32(prior_weight)),
              cuda.ptr(T_out), cuda.ptr(inliers), cuda.stream())
    return T_out, inliers


def pose_only_gn(T_init, xw, uv, valid, cam_K, iters: int = 10,
                 chi2_gate: float = CHI2_MONO, huber: float = 2.447,
                 gate0: float | None = None, depth=None, bf=None):
    """Motion-only Gauss-Newton (PoseOptimization, Optimizer.cc:1063):
    kernel K6 on CUDA tensors, the plain twin on CPU tensors.  ``depth`` /
    ``bf`` add the RGB-D stereo row; ``pose_only_gn_prior`` adds the pose
    prior.  Returns (T (7,), inliers (M,) bool)."""
    if xw.device.type == "cpu":
        return pose_only_gn_torch(T_init, xw, uv, valid, cam_K, iters,
                                  chi2_gate, huber, gate0, depth, bf)
    out = _launch_pose_gn(T_init, xw, uv, valid, cam_K, iters, chi2_gate,
                          huber, gate0, depth, bf, None, 0.0)
    pose_only_gn.launches += 1
    return out


pose_only_gn.launches = 0


def pose_only_gn_prior(T_init, xw, uv, valid, cam_K, T_prior,
                       prior_weight: float, iters: int = 10,
                       chi2_gate: float = CHI2_MONO, huber: float = 2.447,
                       gate0: float | None = None, depth=None, bf=None):
    """K6's pose-prior branch (tracking.py:183-187 of the reference): the
    solve with r = log(T T_prior⁻¹) at isotropic weight ``prior_weight``
    (the inertial path's dead-reckoned prediction), J ≈ I."""
    if xw.device.type == "cpu":
        return pose_only_gn_prior_torch(T_init, xw, uv, valid, cam_K,
                                        T_prior, prior_weight, iters,
                                        chi2_gate, huber, gate0, depth, bf)
    out = _launch_pose_gn(T_init, xw, uv, valid, cam_K, iters, chi2_gate,
                          huber, gate0, depth, bf, T_prior.contiguous(),
                          prior_weight)
    pose_only_gn_prior.launches += 1
    return out


pose_only_gn_prior.launches = 0


class Attempt(NamedTuple):
    """One tracking attempt: the fine pass's pose solve and its inputs."""
    pose: torch.Tensor  # (7,) the fine solve's T_cw
    fine: object  # the fine tracking pass (``features.match.TrackPass``)
    inliers: torch.Tensor  # (n_local,) bool the fine solve's inliers


def _track_attempt(m: MapState, frame: FrameObs, T_pred, ref_kf: int,
                   cam_K, n_window: int = 10, n_local: int = 4096,
                   fx_radius: float = 15.0, fine_radius: float = 7.0,
                   cam_bf=None, img_wh: tuple | None = None,
                   local_table: LocalTable | None = None,
                   prior_weight: float = 0.0):
    """Track one frame against the local map from predicted pose
    ``T_pred``: coarse window match + solve, then fine re-match + solve;
    with ``prior_weight > 0`` both solves pull towards ``T_pred``.  Each
    pass is one ``track_pass`` (projection, gates, window match, gathers).
    Returns (attempt, local table)."""
    if local_table is None:
        local_table = _local_point_table(m, ref_kf, n_window, n_local)
    ids, xw = local_table.ids, local_table.xw

    def match_at(T, radius):
        return track_pass(m.pt_pos, m.pt_desc, ids, T, cam_K, img_wh, radius,
                          frame, want_depth=cam_bf is not None)

    def solve(T0, tp, gate0):
        kw = dict(iters=12, gate0=gate0, bf=cam_bf, depth=tp.depth_m)
        if prior_weight > 0:
            return pose_only_gn_prior(T0, xw, tp.uv_m, tp.ok, cam_K, T_pred,
                                      prior_weight, **kw)
        return pose_only_gn(T0, xw, tp.uv_m, tp.ok, cam_K, **kw)

    T1, _ = solve(T_pred, match_at(T_pred, fx_radius),
                  (2.0 * fx_radius) ** 2)
    fine = match_at(T1, fine_radius)
    T2, inlier_mask = solve(T1, fine, None)
    return Attempt(pose=T2, fine=fine, inliers=inlier_mask), local_table


def _kept_slots(a: Attempt, ids, F: int):
    """The inliers' point ids by keypoint slot and their count: a row that
    is not kept scatters -1, which the max over a table of -1 ignores
    wherever it lands."""
    keep = a.fine.ok & a.inliers
    slot_pt = torch.full((F,), -1, dtype=torch.int32, device=ids.device)
    slot_pt.scatter_reduce_(0, a.fine.slot, torch.where(keep, ids, -1),
                            "amax")
    return slot_pt, keep.sum(dtype=torch.int32)


def _attempt_result(a: Attempt, table: LocalTable, F: int) -> TrackResult:
    slot_pt, n_inl = _kept_slots(a, table.ids, F)
    return TrackResult(pose=a.pose, slot_pt=slot_pt, vis_pt=a.fine.vis_pt,
                       n_matches=a.fine.n_match, n_inliers=n_inl,
                       n_local_pts=table.n_pts)


def inlier_tail_torch(a: Attempt, table: LocalTable, F: int,
                      retried: bool):
    """Plain twin of K25's tail entry: one attempt's kept ids by keypoint
    slot (F,) int32, its inlier count () int32 and the packed (4,) float32
    [n_matches, n_inliers, n_local_pts, retried]."""
    if table.ids.is_cuda:
        inlier_tail_torch.cuda_calls += 1
    slot_pt, n_inl = _kept_slots(a, table.ids, F)
    return slot_pt, n_inl, torch.stack([
        a.fine.n_match.to(torch.float32), n_inl.to(torch.float32),
        table.n_pts.to(torch.float32),
        torch.full((), float(retried), device=table.ids.device)])


inlier_tail_torch.cuda_calls = 0


def _check_attempt(name: str, a: Attempt, ids) -> None:
    fine = a.fine
    if (fine.ok.dtype != torch.bool or a.inliers.dtype != torch.bool
            or fine.slot.dtype != torch.int64 or ids.dtype != torch.int32
            or a.pose.dtype != torch.float32):
        raise ValueError(f"{name}: expected bool masks, int64 slots, int32 "
                         "ids and a float32 pose")


def inlier_tail(a: Attempt, table: LocalTable, F: int, retried: bool):
    """One attempt's inlier tail (see ``inlier_tail_torch``): K25's tail
    entry (``csrc/scan_epilogue.cu``, one launch) on CUDA tensors, the
    twin on CPU tensors.  The three outputs are views of one buffer."""
    if table.ids.device.type == "cpu":
        return inlier_tail_torch(a, table, F, retried)
    cuda.require_cuda("inlier_tail", a.fine.ok, a.fine.slot, a.inliers,
                      table.ids, a.fine.n_match, table.n_pts)
    _check_attempt("inlier_tail", a, table.ids)
    dev = table.ids.device
    ints = torch.empty((F + 1,), dtype=torch.int32, device=dev)
    packed = torch.empty((4,), dtype=torch.float32, device=dev)
    p = ints.data_ptr()
    cuda.call("vsg_inlier_tail", a.fine.ok.data_ptr(),
              a.fine.slot.data_ptr(), a.inliers.data_ptr(),
              table.ids.data_ptr(), a.fine.n_match.data_ptr(),
              table.n_pts.data_ptr(), table.ids.shape[0], F, int(retried),
              p, p + 4 * F, packed.data_ptr(), cuda.stream())
    inlier_tail.launches += 1
    return ints[:F], ints[F], packed


inlier_tail.launches = 0


def _track_frame_impl(m: MapState, frame: FrameObs, T_pred, ref_kf: int,
                      cam_K, n_window: int = 10, n_local: int = 4096,
                      fx_radius: float = 15.0, fine_radius: float = 7.0,
                      cam_bf=None, img_wh: tuple | None = None,
                      local_table: LocalTable | None = None,
                      prior_weight: float = 0.0, retried: bool = False):
    """One tracking attempt (``_track_attempt``) and its inlier tail (K25's
    tail entry).  Returns (result, packed (4,) float32 [n_matches,
    n_inliers, n_local_pts, retried] on the device)."""
    a, table = _track_attempt(m, frame, T_pred, ref_kf, cam_K, n_window,
                              n_local, fx_radius, fine_radius, cam_bf,
                              img_wh, local_table, prior_weight)
    slot_pt, n_inl, packed = inlier_tail(a, table, frame.uv.shape[0],
                                         retried)
    return TrackResult(pose=a.pose, slot_pt=slot_pt, vis_pt=a.fine.vis_pt,
                       n_matches=a.fine.n_match, n_inliers=n_inl,
                       n_local_pts=table.n_pts), packed


def _track_with_retry(m: MapState, frame: FrameObs, T_pred, T_last,
                      ref_kf: int, cam_K, min_inliers: int, n_window: int,
                      n_local: int, fx_radius: float, fine_radius: float,
                      cam_bf, img_wh, prior_weight: float = 0.0):
    """Coarse track at the predicted pose (with the pose prior when
    ``prior_weight > 0``) and, when inliers fall short, the wide-window
    re-track from the last good pose, without the prior.  Returns
    (result, packed host (4,) float32 array [n_matches, n_inliers,
    n_local_pts, retried], device-to-host reads made: 1, or 2 when it
    retried)."""
    res, packed = _track_frame_impl(m, frame, T_pred, ref_kf, cam_K,
                                    n_window, n_local, fx_radius,
                                    fine_radius, cam_bf, img_wh,
                                    prior_weight=prior_weight)
    packed = packed.cpu().numpy()
    if packed[1] >= min_inliers:
        return res, packed, 1
    res, packed = _track_frame_impl(m, frame, T_last, ref_kf, cam_K,
                                    n_window, n_local, fx_radius * 4.0,
                                    fine_radius * 2.0, cam_bf, img_wh,
                                    retried=True)
    return res, packed.cpu().numpy(), 2


def track_frame_full(m: MapState, frame: FrameObs, T_pred, T_last,
                     ref_kf: int, cam_K, min_inliers: int,
                     n_window: int = 10, n_local: int = 4096,
                     fx_radius: float = 15.0, fine_radius: float = 7.0,
                     cam_bf=None, img_wh: tuple | None = None,
                     prior_weight: float = 0.0):
    """Tracking with the retry branch, with the point-stats update folded
    in; ``prior_weight > 0`` pulls the first attempt's solves towards
    ``T_pred`` (the inertial path's prediction).  Returns (result,
    new_map, packed host (4,) float32 array [n_matches, n_inliers,
    n_local_pts, retried])."""
    if T_last.is_cuda:
        track_frame_full.cuda_calls += 1
    res, packed, _ = _track_with_retry(
        m, frame, T_pred, T_last, ref_kf, cam_K, min_inliers, n_window,
        n_local, fx_radius, fine_radius, cam_bf, img_wh, prior_weight)
    return res, update_point_stats(m, res), packed


# serial frames tracked on the card (K27's stats entry launches once each)
track_frame_full.cuda_calls = 0


def make_frame_step(cam, orb, n_window: int, n_local: int, fx_radius: float,
                    fine_radius: float, has_depth: bool) -> Callable:
    """The per-frame step: ORB extraction + prediction + coarse/retry/fine
    tracking + trajectory bookkeeping.

    ``step(m, gray, depth_img, ts, T_last, velocity, ref_kf, cam_K,
    min_inliers, cam_bf=None, timers=None)`` returns (frame, res, pose_sel,
    vel_sel, T_rel, packed, n_readbacks) where ``packed`` is the host
    (4,) float32 array [n_matches, n_inliers, n_local_pts, retried] and
    ``n_readbacks`` the device-to-host reads the step made (1, or 2 when
    it retried)."""
    wh = (cam.width, cam.height)

    def step(m: MapState, gray, depth_img, ts, T_last, velocity,
             ref_kf: int, cam_K, min_inliers: int, cam_bf=None, timers=None):
        with (timers.stage("orb_extract") if timers is not None
              else contextlib.nullcontext()):
            frame = make_frame_obs(gray, depth_img if has_depth else None,
                                   ts, cam, orb)
        T_pred = lie.se3_normalize(lie.se3_multiply(velocity, T_last))
        res, packed, n_read = _track_with_retry(
            m, frame, T_pred, T_last, ref_kf, cam_K, min_inliers, n_window,
            n_local, fx_radius, fine_radius, cam_bf, wh)
        accepted = bool(packed[1] >= min_inliers)
        new_pose = lie.se3_normalize(res.pose)
        pose_sel = new_pose if accepted else T_last
        vel_sel = (lie.se3_normalize(lie.se3_multiply(
            new_pose, lie.se3_inverse(T_last))) if accepted
            else lie.se3_identity(device=new_pose.device))
        T_rel = lie.se3_normalize(
            lie.se3_multiply(pose_sel, lie.se3_inverse(m.kf_pose[ref_kf])))
        return frame, res, pose_sel, vel_sel, T_rel, packed, n_read

    return step


def result_at(results: TrackResult, i: int) -> TrackResult:
    """Frame ``i``'s result out of a scan's stacked results."""
    return TrackResult(*(x[i] for x in results))


def _select(cond, a: TrackResult, b: TrackResult) -> TrackResult:
    """Field by field ``a`` where the device flag ``cond`` holds, else
    ``b`` (no host sync)."""
    return TrackResult(*(torch.where(cond, x, y) for x, y in zip(a, b)))


class ScanOut(NamedTuple):
    """A scan batch's outputs, allocated once a batch and written a row a
    frame by K25, and the scan's state, which each frame's K25 writes for
    the next frame."""
    results: TrackResult  # each field stacked along a leading B
    T_rels: torch.Tensor  # (B, 7) float32
    packeds: torch.Tensor  # (B, 4) float32 [n_matches, n_inliers,
    # n_local_pts, retried]
    state: torch.Tensor  # (3, 7) float32 [T_pred, T_prev, velocity]


def scan_outputs(B: int, F: int, n_local: int, device) -> ScanOut:
    """Uninitialised outputs of a B-frame scan: views of one float32 and
    one int32 buffer (a wrapper's host time counts)."""
    fl = torch.empty((B * 18 + 21,), dtype=torch.float32, device=device)
    pose, T_rels, packeds, state = fl.split((7 * B, 7 * B, 4 * B, 21))
    it = torch.empty((B * (F + n_local + 3),), dtype=torch.int32,
                     device=device)
    slot_pt, vis_pt, counts = it.split((B * F, B * n_local, 3 * B))
    n_matches, n_inliers, n_local_pts = counts.view(3, B)
    return ScanOut(
        results=TrackResult(pose=pose.view(B, 7), slot_pt=slot_pt.view(B, F),
                            vis_pt=vis_pt.view(B, n_local),
                            n_matches=n_matches, n_inliers=n_inliers,
                            n_local_pts=n_local_pts),
        T_rels=T_rels.view(B, 7), packeds=packeds.view(B, 4),
        state=state.view(3, 7))


def scan_prologue_torch(T_last, velocity, state) -> None:
    """Plain twin of K25's first-frame entry: state = [normalize(velocity
    T_last), T_last, velocity]."""
    if state.is_cuda:
        scan_prologue_torch.cuda_calls += 1
    state[0] = lie.se3_normalize(lie.se3_multiply(velocity, T_last))
    state[1] = T_last
    state[2] = velocity


scan_prologue_torch.cuda_calls = 0


def scan_prologue(T_last, velocity, state) -> None:
    """The scan's first prediction (see ``scan_prologue_torch``): K25's
    first-frame entry (one thread) on CUDA tensors, the twin on CPU."""
    if state.device.type == "cpu":
        return scan_prologue_torch(T_last, velocity, state)
    cuda.require_cuda("scan_prologue", T_last, velocity, state)
    if (T_last.dtype != torch.float32 or velocity.dtype != torch.float32
            or state.dtype != torch.float32):
        raise ValueError("scan_prologue: float32 poses")
    cuda.call("vsg_scan_prologue", T_last.data_ptr(), velocity.data_ptr(),
              state.data_ptr(), cuda.stream())
    scan_prologue.launches += 1


scan_prologue.launches = 0


def scan_epilogue_torch(a1: Attempt, a2: Attempt, table: LocalTable,
                        kf_base, min_inliers: int, i: int,
                        out: ScanOut) -> None:
    """Plain twin of K25: the reference's scan step after the two attempts
    (``tracking.py:478-510``; the attempts' inlier tails, the retry
    choice, the accepted pose, the velocity, T_rel, the packed row), the
    results written into row ``i`` of ``out`` and the next frame's
    prediction, pose and velocity into ``out.state``."""
    if kf_base.is_cuda:
        scan_epilogue_torch.cuda_calls += 1
    F = out.results.slot_pt.shape[1]
    T_prev = out.state[1]
    res1, res2 = (_attempt_result(a, table, F) for a in (a1, a2))
    need_retry = res1.n_inliers < min_inliers
    res = _select(need_retry, res2, res1)
    accepted = res.n_inliers >= min_inliers
    new_pose = lie.se3_normalize(res.pose)
    pose_sel = torch.where(accepted, new_pose, T_prev)
    vel_new = lie.se3_normalize(
        lie.se3_multiply(new_pose, lie.se3_inverse(T_prev)))
    vel_sel = torch.where(accepted, vel_new,
                          lie.se3_identity(device=T_prev.device))
    for field, value in zip(out.results, res):
        field[i] = value
    out.T_rels[i] = lie.se3_normalize(
        lie.se3_multiply(pose_sel, lie.se3_inverse(kf_base)))
    out.packeds[i] = torch.stack([
        res.n_matches.to(torch.float32), res.n_inliers.to(torch.float32),
        res.n_local_pts.to(torch.float32), need_retry.to(torch.float32)])
    out.state[0] = lie.se3_normalize(lie.se3_multiply(vel_sel, pose_sel))
    out.state[1] = pose_sel
    out.state[2] = vel_sel


scan_epilogue_torch.cuda_calls = 0


def scan_epilogue(a1: Attempt, a2: Attempt, table: LocalTable, kf_base,
                  min_inliers: int, i: int, out: ScanOut) -> None:
    """A scan frame's bookkeeping (see ``scan_epilogue_torch``): kernel
    K25 (``csrc/scan_epilogue.cu``, one launch) on CUDA tensors, the twin
    on CPU tensors."""
    if kf_base.device.type == "cpu":
        return scan_epilogue_torch(a1, a2, table, kf_base, min_inliers, i,
                                   out)
    r = out.results
    B, F = r.slot_pt.shape
    N = table.ids.shape[0]
    if not 0 <= i < B or r.vis_pt.shape[1] != N:
        raise ValueError("scan_epilogue: row or table size out of range")
    cuda.require_cuda("scan_epilogue", *(t for a in (a1, a2) for t in (
        a.fine.ok, a.fine.slot, a.fine.vis_pt, a.fine.n_match, a.pose,
        a.inliers)), table.ids, table.n_pts, kf_base, out.state)
    _check_attempt("scan_epilogue", a1, table.ids)
    _check_attempt("scan_epilogue", a2, table.ids)
    att = [t.data_ptr() for a in (a1, a2) for t in (
        a.fine.ok, a.fine.slot, a.fine.vis_pt, a.fine.n_match, a.pose,
        a.inliers)]
    cuda.call("vsg_scan_epilogue", *att, table.ids.data_ptr(),
              table.n_pts.data_ptr(), N, F, kf_base.data_ptr(),
              int(min_inliers), out.state.data_ptr(),
              r.pose.data_ptr() + 28 * i, r.slot_pt.data_ptr() + 4 * F * i,
              r.vis_pt.data_ptr() + 4 * N * i, r.n_matches.data_ptr() + 4 * i,
              r.n_inliers.data_ptr() + 4 * i,
              r.n_local_pts.data_ptr() + 4 * i,
              out.T_rels.data_ptr() + 28 * i,
              out.packeds.data_ptr() + 16 * i, cuda.stream())
    scan_epilogue.launches += 1


scan_epilogue.launches = 0


@functools.lru_cache(maxsize=None)
def make_frame_scan(cam, orb, n_window: int, n_local: int, fx_radius: float,
                    fine_radius: float, has_depth: bool,
                    batch: int) -> Callable:
    """The B-frame pipelined tracking program (reference
    ``tracking.py:445-514``): the local-point table, its positions and
    its size are built once per batch (the map and the reference keyframe
    are constant inside it), ORB is
    extracted for all B frames at once (K1-K4 launch once per level for
    the batch; tracking does not depend on it frame by frame), then the
    per-frame step runs over the frames in order, carrying (T_prev, vel)
    in a small device state: K25's first-frame entry makes the first
    prediction, and each frame's two attempts (the prediction's, and the
    wide retry from the last pose, computed for every frame) are followed
    by one K25 launch that chooses between them on the device, writes the
    frame's row of the batch's outputs and the next frame's prediction.
    The scan makes no host sync.

    ``scan(m, grays, depths, tss, T_last, velocity, ref_kf, cam_K,
    min_inliers, cam_bf=None, timers=None)`` returns (frames, results,
    T_rels (B, 7), packeds (B, 4) device float32 [n_matches, n_inliers,
    n_local_pts, retried], T_out, vel_out), frames and results stacked
    along a leading B."""
    wh = (cam.width, cam.height)

    def scan(m: MapState, grays, depths, tss, T_last, velocity, ref_kf: int,
             cam_K, min_inliers: int, cam_bf=None, timers=None):
        if grays.shape[0] != batch:
            raise ValueError(f"make_frame_scan: expected {batch} frames")
        kf_base = m.kf_pose[ref_kf]
        table = _local_point_table(m, ref_kf, n_window, n_local)
        with (timers.stage("orb_extract") if timers is not None
              else contextlib.nullcontext()):
            frames = make_frame_obs(grays, depths if has_depth else None,
                                    tss, cam, orb)
        if T_last.is_cuda:
            make_frame_scan.cuda_scans += 1
            make_frame_scan.cuda_frames += batch
        out = scan_outputs(batch, frames.uv.shape[1], n_local, T_last.device)
        scan_prologue(T_last, velocity, out.state)
        T_pred, T_prev = out.state[0], out.state[1]
        for i in range(batch):
            frame = frame_at(frames, i)
            a1, _ = _track_attempt(m, frame, T_pred, ref_kf, cam_K,
                                   n_window, n_local, fx_radius, fine_radius,
                                   cam_bf, wh, local_table=table)
            a2, _ = _track_attempt(m, frame, T_prev, ref_kf, cam_K,
                                   n_window, n_local, fx_radius * 4.0,
                                   fine_radius * 2.0, cam_bf, wh,
                                   local_table=table)
            scan_epilogue(a1, a2, table, kf_base, min_inliers, i, out)
        return (frames, out.results, out.T_rels, out.packeds, out.state[1],
                out.state[2])

    return scan


# scans and frames scanned on the card (K25's first-frame entry launches
# once a scan, its frame entry once a frame)
make_frame_scan.cuda_scans = 0
make_frame_scan.cuda_frames = 0


def update_point_stats(m: MapState, track: TrackResult) -> MapState:
    """Increment visible/found counters used by point culling
    (MapPoint::IncreaseVisible/IncreaseFound): one row of
    ``mapping.apply_found_stats`` (K27's stats entry on the card)."""
    from visual_sgraphs_tpu_torch.slam.mapping import apply_found_stats
    return apply_found_stats(m, track.slot_pt, track.vis_pt)
