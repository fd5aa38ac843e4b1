"""Landmark-grouped Schur reduction for bundle adjustment (kernel K8).

Port of the single-device core of ``visual_sgraphs_tpu/parallel/
dist_ba.py``: with landmark n observed by keyframes k in obs(n),

    S  =  H_pp  -  sum_n  W_n^T Hxx_n^-1 W_n,      rhs analogous,

so the reduction is local to each landmark.  Observations are grouped per
landmark into (N, O) tables; the reduced (6K, 6K) camera system is
assembled densely in float32 (TF32 must stay off: the terms span ~8
orders of magnitude) and the landmarks are back-substituted.

``local_reduced_system`` and ``back_substitute`` launch the hand kernels
in ``csrc/schur.cu`` on CUDA tensors and run the plain twins
``local_reduced_system_torch`` / ``back_substitute_torch`` on CPU
tensors.  The twins scatter per observation and per ordered observation
pair with ``index_add_`` (the reference's one-hot contractions, a layout
chosen for the TPU's matrix unit, cost O(n L^2) and are too slow at the
global BA's L = 128 on a CPU); the kernel reduces per landmark in one
launch, as a Gram sum: each landmark's observations of one slot collapse
into P_s, B_s = chol(Hxx)^-1 P_s^T and the pair blocks are B_s^T B_t.

``global_ba_sharded`` is the one-device global BA of loop closing
(LoopClosing::RunGlobalBundleAdjustment): every keyframe and point of the
map, observations grouped per landmark (``max_obs`` = 8), K8 at L = K.
The mesh / NCCL path (landmarks sharded over devices, one all-reduce of
the reduced system per iteration) is not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import lie


def group_observations_torch(obs_kf, obs_pt, uvr, valid, n_pt: int,
                             max_obs: int = 8):
    """Plain twin of K9: flat observation lists -> per-landmark (N, O)
    tables: each observation lands in its landmark's next free slot (rank
    = earlier list entries of the same point: stable sort + run position).
    Overflow beyond ``max_obs`` is dropped.  Returns (kf (N, O) int32,
    uvr (N, O, 3), valid (N, O) bool, n_dropped)."""
    if obs_kf.is_cuda:
        group_observations_torch.cuda_calls += 1
    m = obs_kf.shape[0]
    dev = obs_kf.device
    pt = torch.where(valid, obs_pt, n_pt).long()
    pt_sorted, order = torch.sort(pt, stable=True)
    pos = torch.arange(m, device=dev)
    first = torch.searchsorted(pt_sorted, pt_sorted, side="left")
    rank = torch.empty((m,), dtype=torch.int64, device=dev)
    rank[order] = pos - first
    keep = valid & (rank < max_obs) & (obs_pt >= 0) & (obs_pt < n_pt)
    # rows that are not kept all land in the dump row n_pt (cut below)
    row = torch.where(keep, obs_pt.long(), n_pt)
    col = torch.where(keep, rank, 0)
    out_kf = torch.full((n_pt + 1, max_obs), -1, dtype=torch.int32,
                        device=dev)
    out_kf[row, col] = torch.where(keep, obs_kf.to(torch.int32), -1)
    out_uvr = torch.zeros((n_pt + 1, max_obs, 3), dtype=uvr.dtype, device=dev)
    out_uvr[row, col] = torch.where(keep[:, None], uvr, 0.0)
    out_valid = torch.zeros((n_pt + 1, max_obs), dtype=torch.bool, device=dev)
    out_valid[row, col] = keep
    n_dropped = (valid & (rank >= max_obs)).sum(dtype=torch.int32)
    return out_kf[:n_pt], out_uvr[:n_pt], out_valid[:n_pt], n_dropped


group_observations_torch.cuda_calls = 0

# K9's launch plan (csrc/group_obs.cu): clusters of GROUP_CLUSTER CTAs
# (the portable cluster size) of GROUP_WARPS warps; a cluster a slice of
# the buckets [0, n_pt], at least GROUP_MIN_WIDTH buckets wide, up to
# GROUP_SLICES slices (more only when a slice's counters would not fit a
# CTA's shared memory, cuda.SMEM_LIMIT)
GROUP_CLUSTER = 8
GROUP_WARPS = 16
GROUP_SLICES = 16
GROUP_MIN_WIDTH = 64
GROUP_HEADER = 16


class GroupPlan(NamedTuple):
    slices: int  # clusters
    width: int  # buckets a slice (a multiple of 4)
    cluster: int  # CTAs a cluster
    seg: int  # list entries a warp segment
    smem: int  # shared-memory bytes a CTA
    side: int  # entries of the out-of-range scratch list


def group_plan(m: int, n_pt: int) -> GroupPlan:
    """K9's launch plan for m list entries and n_pt landmarks.  A CTA's
    shared memory holds a 16-byte header, GROUP_WARPS counter rows, its
    totals, the totals before it and the cluster's totals (a byte a
    bucket each), and a code (2 bytes) and a rank (1 byte) for each entry
    of its segment; raises when no slice width fits."""
    buckets = n_pt + 1
    seg = -(-m // (GROUP_CLUSTER * GROUP_WARPS))
    fixed = GROUP_HEADER + 3 * GROUP_WARPS * seg
    max_width = (cuda.SMEM_LIMIT - fixed) // (GROUP_WARPS + 3) // 4 * 4
    if max_width < 4:
        raise ValueError(f"group_observations: {m} entries exceed the "
                         "kernel's shared memory")
    slices = max(1, min(GROUP_SLICES, -(-buckets // GROUP_MIN_WIDTH)),
                 -(-buckets // max_width))
    width = -(-buckets // slices)
    width = -(-width // 4) * 4
    return GroupPlan(slices=slices, width=width, cluster=GROUP_CLUSTER,
                     seg=seg, smem=fixed + (GROUP_WARPS + 3) * width,
                     side=GROUP_CLUSTER * GROUP_WARPS * seg)


def group_observations(obs_kf, obs_pt, uvr, valid, n_pt: int,
                       max_obs: int = 8):
    """Per-landmark observation tables (see ``group_observations_torch``):
    kernel K9 (``csrc/group_obs.cu``, one launch: stable per-bucket ranks
    over slices of the bucket range, one cluster a slice) on CUDA
    tensors, the plain twin on CPU tensors.  Every output is written by
    the kernel; the scratch is not initialised."""
    if obs_kf.device.type == "cpu":
        return group_observations_torch(obs_kf, obs_pt, uvr, valid, n_pt,
                                        max_obs)
    cuda.require_cuda("group_observations", obs_kf, obs_pt, uvr, valid)
    if (obs_kf.dtype != torch.int32 or obs_pt.dtype != torch.int32
            or uvr.dtype != torch.float32 or valid.dtype != torch.bool):
        raise ValueError("group_observations: expected int32 ids, float32 "
                         "uvr and a bool mask")
    if not 1 <= max_obs <= 255:
        raise ValueError("group_observations: max_obs must lie in [1, 255]")
    m = obs_kf.shape[0]
    dev = obs_kf.device
    plan = group_plan(m, n_pt)
    # one scratch buffer: the out-of-range list, the clusters' drops
    scratch = torch.empty((plan.side + plan.slices,), dtype=torch.int32,
                          device=dev)
    side = scratch.data_ptr()
    out_kf = torch.empty((n_pt, max_obs), dtype=torch.int32, device=dev)
    out_uvr = torch.empty((n_pt, max_obs, 3), dtype=torch.float32,
                          device=dev)
    out_valid = torch.empty((n_pt, max_obs), dtype=torch.bool, device=dev)
    n_dropped = torch.empty((), dtype=torch.int32, device=dev)
    cuda.call("vsg_group_obs", cuda.ptr(obs_kf), cuda.ptr(obs_pt),
              cuda.ptr(uvr), cuda.ptr(valid), m, n_pt, max_obs,
              plan.slices, plan.width, plan.cluster, plan.seg, plan.smem,
              side, side + 4 * plan.side,
              cuda.ptr(out_kf), cuda.ptr(out_uvr), cuda.ptr(out_valid),
              cuda.ptr(n_dropped), cuda.stream())
    group_observations.launches += 1
    return out_kf, out_uvr, out_valid, n_dropped


group_observations.launches = 0


def _landmark_terms(kf_pose, X_w, kf_idx, uvr, ovalid, cam_K, bf, huber):
    """Schur terms of every landmark at once: residuals r (n, O, 3), pose
    Jacobians Jp (n, O, 3, 6), point Jacobians Jx (n, O, 3, 3), weights
    w (n, O) and the cost."""
    fx, fy, cx, cy = cam_K[0], cam_K[1], cam_K[2], cam_K[3]
    T = kf_pose[torch.clamp(kf_idx, min=0).long()]  # (n, O, 7)
    R = lie.quat_to_matrix(T[..., :4])  # (n, O, 3, 3)
    p = torch.einsum("noij,nj->noi", R, X_w) + T[..., 4:7]
    z = torch.clamp(p[..., 2], min=1e-6)
    inv_z = 1.0 / z
    u_hat = fx * p[..., 0] * inv_z + cx
    v_hat = fy * p[..., 1] * inv_z + cy
    has_ur = uvr[..., 2] > 0
    ur_hat = u_hat - bf * inv_z
    disp = torch.clamp(uvr[..., 0] - uvr[..., 2], min=1e-3)
    z_meas = torch.where(has_ur, bf / disp, 1.0)
    w_ur = torch.clamp((2.5 / torch.clamp(z_meas, min=0.1)) ** 2, max=1.0)
    r = torch.stack([
        u_hat - uvr[..., 0],
        v_hat - uvr[..., 1],
        torch.where(has_ur, (ur_hat - uvr[..., 2]) * w_ur, 0.0),
    ], dim=-1)
    chi2 = torch.sum(r * r, dim=-1)
    ok = ovalid & (kf_idx >= 0) & (p[..., 2] > 0.05)
    w = torch.where(ok, 1.0, 0.0) * torch.clamp(
        huber / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
    zero = torch.zeros_like(z)
    Jp_p = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z], -1),
        torch.stack([fx * inv_z, zero,
                     (-fx * p[..., 0] + bf) * inv_z * inv_z], -1)
        * (has_ur * w_ur)[..., None],
    ], dim=-2)  # (n, O, 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1] + (3, 3))
    Jx_pose = torch.cat([eye, -lie.hat(p)], dim=-1)  # (n, O, 3, 6)
    Jp = Jp_p @ Jx_pose
    Jx = Jp_p @ R
    cost = torch.sum(w * chi2)
    return r, Jp, Jx, w, cost


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C_ = b * f - c * e
    D = f * g - d * i
    E_ = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I_ = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    adj = torch.stack([
        torch.stack([A, B, C_], dim=-1),
        torch.stack([D, E_, F], dim=-1),
        torch.stack([G, H, I_], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def local_reduced_system_torch(kf_pose, pts, kf_tab, uvr_tab, val_tab, cam_K,
                               bf, lam, huber):
    """Plain twin of K8's reduction: dense reduced system + landmark
    factor cache.

    Returns (S (6K, 6K), rhs (6K,), Hinv (n, 3, 3) of the damped Hxx,
    bx (n, 3), W (n, O, 6, 3), cost)."""
    if kf_pose.is_cuda:
        local_reduced_system_torch.cuda_calls += 1
    K = kf_pose.shape[0]
    n, O = kf_tab.shape
    r, Jp, Jx, w, cost = _landmark_terms(kf_pose, pts, kf_tab, uvr_tab,
                                         val_tab, cam_K, bf, huber)
    Hpp = torch.einsum("nori,norj,no->noij", Jp, Jp, w)  # (n, O, 6, 6)
    Hxx = torch.einsum("nori,norj,no->nij", Jx, Jx, w)  # (n, 3, 3)
    W = torch.einsum("nori,norj,no->noij", Jp, Jx, w)  # (n, O, 6, 3)
    gp = torch.einsum("nori,nor,no->noi", Jp, r, w)  # (n, O, 6)
    bx = torch.einsum("nori,nor,no->ni", Jx, r, w)  # (n, 3)

    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    dx = torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-6)
    Hxx = Hxx + (lam * dx + 1e-5)[..., None] * eye3
    Hinv = _inv3x3(Hxx)

    kf_safe = torch.clamp(kf_tab, min=0).long()
    slot_ok = val_tab & (kf_tab >= 0)
    okf = slot_ok.to(r.dtype)
    S1 = torch.zeros((K, 6, 6), dtype=r.dtype, device=r.device)
    S1.index_add_(0, kf_safe.reshape(-1),
                  (Hpp * okf[..., None, None]).reshape(-1, 6, 6))
    # the pair blocks of landmarks with an observation (the tables are
    # sized for the window's capacity, most rows empty; this twin runs on
    # the card only to check the kernel, where the index's sync is moot)
    act = torch.nonzero(slot_ok.any(dim=1))[:, 0]
    WH = torch.einsum("nari,nij->narj", W[act], Hinv[act])  # (n', O, 6, 3)
    # every ordered pair of a landmark's observations: the block
    # (W_a Hinv) W_b^T lands at keyframes (k_a, k_b)
    oka, kfa = okf[act], kf_safe[act]
    pair = torch.einsum("nari,nbsi->nabrs", WH, W[act]) \
        * (oka[:, :, None] * oka[:, None, :])[..., None, None]
    S2 = torch.zeros((K * K, 6, 6), dtype=r.dtype, device=r.device)
    S2.index_add_(0, (kfa[:, :, None] * K + kfa[:, None, :]).reshape(-1),
                  pair.reshape(-1, 6, 6))
    S2 = S2.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    S = (-0.5 * (S2 + S2.T)).reshape(K, 6, K, 6)
    kk = torch.arange(K, device=r.device)
    S[kk, :, kk, :] += S1
    hb = torch.einsum("nij,nj->ni", Hinv, bx)
    Wb = torch.einsum("nari,ni->nar", W, hb)
    rhs = torch.zeros((K, 6), dtype=r.dtype, device=r.device)
    rhs.index_add_(0, kf_safe.reshape(-1),
                   ((Wb - gp) * okf[..., None]).reshape(-1, 6))
    return S.reshape(6 * K, 6 * K), rhs.reshape(6 * K), Hinv, bx, W, cost


def back_substitute_torch(Hinv, bx, W, kf_tab, val_tab, dxr6):
    """Plain twin of K8's back-substitution: the per-landmark update
    dx_n = -Hxx^-1 (bx + sum_a W_a^T dxi_{kf_a}) (non-finite -> 0)."""
    if Hinv.is_cuda:
        back_substitute_torch.cuda_calls += 1
    kf_safe = torch.clamp(kf_tab, min=0).long()
    slot_ok = val_tab & (kf_tab >= 0)
    dpose = dxr6[kf_safe] * slot_ok[..., None]
    y = bx + torch.einsum("nari,nar->ni", W, dpose)
    dxe = -torch.einsum("nij,nj->ni", Hinv, y)
    return torch.where(torch.isfinite(dxe), dxe, 0.0)


local_reduced_system_torch.cuda_calls = 0
back_substitute_torch.cuda_calls = 0


def solve_damped(S, rhs, free, lam: float):
    """Levenberg-damped, gauge-masked Cholesky solve.  ``cholesky_ex``
    reports failure on the device (no sync): a failed factorisation shows
    up as non-finite steps, zeroed here."""
    diag = torch.clamp(torch.diagonal(S), min=1e-6)
    S = S + torch.diag(lam * diag + 1e-5)
    S = S * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    chol, _ = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve((rhs * free)[:, None], chol)[:, 0]
    return torch.where(torch.isfinite(dx), dx, 0.0) * free


def _check_tables(name, kf_tab, uvr_tab, val_tab):
    if kf_tab.dtype != torch.int32 or val_tab.dtype != torch.bool:
        raise ValueError(f"{name}: kf_tab must be int32 and val_tab bool")
    if uvr_tab is not None and uvr_tab.dtype != torch.float32:
        raise ValueError(f"{name}: uvr_tab must be float32")


@functools.lru_cache(maxsize=64)
def _schur_scratch_bytes(n: int, O: int, L: int) -> int:
    return cuda.query("vsg_schur_scratch_bytes", n, O, L)


def local_reduced_system(kf_pose, pts, kf_tab, uvr_tab, val_tab, cam_K, bf,
                         lam: float, huber: float):
    """Reduced camera system (kernel K8 on CUDA tensors, the twin on CPU).
    ``bf`` is a 0-d tensor on the tables' device.  Same results as
    ``local_reduced_system_torch``; on the card one launch, summed in an
    order fixed by the data (bitwise equal from launch to launch)."""
    if kf_pose.device.type == "cpu":
        return local_reduced_system_torch(kf_pose, pts, kf_tab, uvr_tab,
                                          val_tab, cam_K, bf, lam, huber)
    cuda.require_cuda("local_reduced_system", kf_pose, pts, kf_tab, uvr_tab,
                      val_tab, cam_K, bf)
    for t in (kf_pose, pts, cam_K, bf):
        if t.dtype != torch.float32:
            raise ValueError("local_reduced_system: float32 inputs only")
    _check_tables("local_reduced_system", kf_tab, uvr_tab, val_tab)
    L = kf_pose.shape[0]
    n, O = kf_tab.shape
    dev = kf_pose.device
    S = torch.empty((6 * L, 6 * L), dtype=torch.float32, device=dev)
    rhs = torch.empty((6 * L,), dtype=torch.float32, device=dev)
    Hinv = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    bx = torch.empty((n, 3), dtype=torch.float32, device=dev)
    W = torch.empty((n, O, 6, 3), dtype=torch.float32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    # the kernel's partial sums (or, at large L, its staged landmarks and
    # per-slot lists); every output is written by the kernel
    scratch = torch.empty((_schur_scratch_bytes(n, O, L),),
                          dtype=torch.uint8, device=dev)
    cuda.call(
        "vsg_schur_reduce", cuda.ptr(kf_pose), cuda.ptr(pts),
        cuda.ptr(kf_tab), cuda.ptr(uvr_tab), cuda.ptr(val_tab),
        cuda.ptr(cam_K), cuda.ptr(bf), n, O, L, float(np.float32(lam)),
        float(np.float32(huber)), cuda.ptr(S), cuda.ptr(rhs), cuda.ptr(Hinv),
        cuda.ptr(bx), cuda.ptr(W), cuda.ptr(cost), cuda.ptr(scratch),
        cuda.stream())
    local_reduced_system.launches += 1
    return S, rhs, Hinv, bx, W, cost


local_reduced_system.launches = 0


def back_substitute(Hinv, bx, W, kf_tab, val_tab, dxr6):
    """Landmark back-substitution (kernel K8 on CUDA tensors, the twin on
    CPU).  Same results as ``back_substitute_torch``."""
    if Hinv.device.type == "cpu":
        return back_substitute_torch(Hinv, bx, W, kf_tab, val_tab, dxr6)
    cuda.require_cuda("back_substitute", Hinv, bx, W, kf_tab, val_tab, dxr6)
    for t in (Hinv, bx, W, dxr6):
        if t.dtype != torch.float32:
            raise ValueError("back_substitute: float32 inputs only")
    _check_tables("back_substitute", kf_tab, None, val_tab)
    n, O = kf_tab.shape
    dxe = torch.empty((n, 3), dtype=torch.float32, device=Hinv.device)
    cuda.call("vsg_schur_backsub", cuda.ptr(Hinv), cuda.ptr(bx), cuda.ptr(W),
              cuda.ptr(kf_tab), cuda.ptr(val_tab), cuda.ptr(dxr6), n, O,
              dxr6.shape[0], cuda.ptr(dxe), cuda.stream())
    back_substitute.launches += 1
    return dxe


back_substitute.launches = 0


# ---------------------------------------------------------------------------
# one-device global BA
# ---------------------------------------------------------------------------


def _step_body(kf_pose, pts, kf_tab, uvr_tab, val_tab, valid_pt, cam_K,
               fixed_kf, lam: float, bf, huber: float, iters: int):
    """``iters`` Gauss-Newton iterations: K8's reduction, the damped
    reduced solve, the pose update and K8's back-substitution.  Returns
    (poses, points, costs (iters,))."""
    K = kf_pose.shape[0]
    free = (~fixed_kf).repeat_interleave(6).to(kf_pose.dtype)
    pose, costs = kf_pose, []
    for _ in range(iters):
        S, rhs, Hinv, bx, W, cost = local_reduced_system(
            pose, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam, huber)
        dxr6 = solve_damped(S, rhs, free, lam).reshape(K, 6)
        new_pose = lie.se3_normalize(lie.se3_boxplus(
            pose, torch.where(fixed_kf[:, None], 0.0, dxr6)))
        dxe = back_substitute(Hinv, bx, W, kf_tab, val_tab, dxr6)
        pts = pts + torch.where(valid_pt[:, None], dxe, 0.0)
        pose = new_pose
        costs.append(cost)
    return pose, pts, torch.stack(costs)


def global_ba_sharded(m, cam_K, cam_bf, iters: int = 10, max_obs: int = 8):
    """Global BA straight from a ``MapState`` on one device: keyframe slot
    0 and invalid slots fixed.  Returns (map, costs (iters,))."""
    K = m.K
    dev = m.kf_pose.device
    obs = m.kf_obs_pt
    ok = m.kf_kp_valid & m.kf_valid[:, None] & (obs >= 0)
    safe = torch.clamp(obs, min=0)
    ok = ok & m.pt_valid[safe.long()]
    kf_rows = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(
        obs.shape)
    uv = m.kf_uv.reshape(-1, 2)
    depth = m.kf_depth.reshape(-1)
    ur = torch.where(depth > 0,
                     uv[:, 0] - cam_bf / torch.clamp(depth, min=1e-3), -1.0)
    uvr = torch.cat([uv, ur[:, None]], dim=1)
    fixed = (~m.kf_valid) | (torch.arange(K, device=dev) == 0)
    # K9: observations grouped per landmark
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        kf_rows.reshape(-1), safe.reshape(-1), uvr, ok.reshape(-1),
        m.pt_pos.shape[0], max_obs)
    pose, pts, costs = _step_body(m.kf_pose, m.pt_pos, kf_tab, uvr_tab,
                                  val_tab, m.pt_valid, cam_K, fixed,
                                  lam=1e-4, bf=cam_bf, huber=2.45,
                                  iters=iters)
    return m._replace(
        kf_pose=torch.where(fixed[:, None], m.kf_pose, pose),
        pt_pos=torch.where(m.pt_valid[:, None], pts, m.pt_pos)), costs
