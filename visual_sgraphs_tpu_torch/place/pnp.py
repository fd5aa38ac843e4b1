"""Batched PnP RANSAC for relocalisation (kernel K15, PnP half).

Port of ``visual_sgraphs_tpu/place/pnp.py`` (the MLPnPsolver replacement
of Tracking::Relocalization): H minimal 6-point DLT problems (the smallest
eigenvector of each 12x12 AᵀA, the depth-sign fix, the procrustes
rotation and the scale), scored by their reprojection inlier counts over
all matches (non-finite poses score -1), the first best winning, and the
winner refined by the motion-only Gauss-Newton (kernel K6) with a wide
first gate.

The JAX function draws its 6-point picks from a key; here they come in as
an explicit (n_hyp, 6) index tensor.

The kernel forms each AᵀA and solves its eigenvectors in float64: AᵀA
squares the conditioning of A, and no float32 Jacobi sweep reproduces a
float32 LAPACK eigenvector in the near-null space.  The twin keeps the
reference's float32 eigensolve, so on CPU tensors the port computes what
the reference computes; with ``eig_dtype=torch.float64`` it computes in the
kernel's precision, and that is what the kernel is held against.  On
coplanar picks (a map of walls) the DLT is degenerate, the near-null space
has more than one dimension, and the two precisions choose different
vectors in it: there the winning hypothesis, and what the refinement makes
of it, depend on rounding in both packages.  ``pnp_hypotheses`` runs the DLTs,
the scoring and the choice as the hand kernel in ``csrc/sim3.cu`` (two
launches) on CUDA tensors and the plain twin ``pnp_hypotheses_torch`` on
CPU tensors; ``ransac_pnp`` adds the K6 refinement.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import cameras, lie
from visual_sgraphs_tpu_torch.slam.tracking import pose_only_gn


class PnPResult(NamedTuple):
    T_cw: torch.Tensor  # (7,) best pose
    n_inliers: torch.Tensor  # () int32
    inliers: torch.Tensor  # (M,) bool


def _dlt_pose(xw, xy, eig_dtype=None):
    """6-point DLTs: world points (H, 6, 3) + normalised image points
    (H, 6, 2) -> T_cw (H, 7).  AᵀA and its eigenvectors are computed in
    ``eig_dtype`` (default: the inputs' type, the reference's arithmetic);
    the rest in the inputs' type."""
    X = torch.cat([xw, torch.ones(xw.shape[:-1] + (1,), dtype=xw.dtype,
                                  device=xw.device)], dim=-1)  # (H, 6, 4)
    zero = torch.zeros_like(X)
    r1 = torch.cat([X, zero, -xy[..., 0:1] * X], dim=-1)
    r2 = torch.cat([zero, X, -xy[..., 1:2] * X], dim=-1)
    A = torch.cat([r1, r2], dim=-2).to(eig_dtype or xw.dtype)  # (H, 12, 12)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P = V[..., :, 0].to(xw.dtype).reshape(V.shape[:-2] + (3, 4))
    M, t = P[..., :3], P[..., 3]
    X0 = X[..., 0, :3]
    # the sign that puts the first point in front of the camera (the
    # reference adds the sum of all three coordinates times 0)
    depth = (torch.einsum("...j,...ij->...i", X0, M) + t).sum(-1) * 0 + (
        torch.sum(X0 * M[..., 2, :], dim=-1) + t[..., 2])
    sign = torch.sign(depth)
    M = M * sign[..., None, None]
    t = t * sign[..., None]
    U, S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.zeros(M.shape, dtype=M.dtype, device=M.device)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    R = U @ D @ Vt
    scale = torch.mean(S, dim=-1)
    t = t / torch.clamp(scale, min=1e-9)[..., None]
    return lie.se3_normalize(torch.cat([lie.matrix_to_quat(R), t], dim=-1))


def _normalised(uv, cam_K):
    return torch.stack([(uv[:, 0] - cam_K[2]) / cam_K[0],
                        (uv[:, 1] - cam_K[3]) / cam_K[1]], dim=1)


def pnp_hypotheses_torch(xw, uv, valid, cam_K, picks,
                         inlier_px: float = 5.0, eig_dtype=None):
    """Plain twin of K15's PnP half: the DLT of every pick row, its
    inlier count, and the first best pose (identity if not finite).
    ``eig_dtype``: the type of the DLT eigensolve (default float32, the
    reference's; the kernel's is float64).  Returns (T0 (7,), counts (H,)
    int32)."""
    if xw.is_cuda:
        pnp_hypotheses_torch.cuda_calls += 1
    idx = picks.long()
    poses = _dlt_pose(xw[idx], _normalised(uv, cam_K)[idx],
                      eig_dtype)  # (H, 7)
    p = lie.se3_apply(poses[:, None, :], xw[None])  # (H, M, 3)
    err = torch.sum((cameras.project_pinhole(cam_K, p) - uv[None]) ** 2,
                    dim=-1)
    inl = valid[None] & (p[..., 2] > 0.05) & (err < inlier_px * inlier_px)
    counts = inl.sum(dim=1, dtype=torch.int32)
    finite = torch.all(torch.isfinite(poses), dim=1)
    counts = torch.where(finite, counts, -1)
    best = torch.argmax(counts)
    T0 = poses[best]
    T0 = torch.where(torch.all(torch.isfinite(T0)), T0,
                     lie.se3_identity(T0.dtype, T0.device))
    return T0, counts


pnp_hypotheses_torch.cuda_calls = 0


def pnp_hypotheses(xw, uv, valid, cam_K, picks, inlier_px: float = 5.0):
    """DLT hypotheses, scores and choice (kernel K15's PnP half on CUDA
    tensors, the twin on CPU); the outputs of ``pnp_hypotheses_torch``."""
    if xw.device.type == "cpu":
        return pnp_hypotheses_torch(xw, uv, valid, cam_K, picks, inlier_px)
    cuda.require_cuda("pnp_hypotheses", xw, uv, valid, cam_K, picks)
    if any(t.dtype != torch.float32 for t in (xw, uv, cam_K)) \
            or valid.dtype != torch.bool or picks.dtype != torch.int32 \
            or picks.shape[1] != 6:
        raise ValueError("pnp_hypotheses: float32 points, bool mask, "
                         "(H, 6) int32 picks")
    M, H = xw.shape[0], picks.shape[0]
    dev = xw.device
    poses = torch.empty((H, 7), dtype=torch.float32, device=dev)
    counts = torch.empty((H,), dtype=torch.int32, device=dev)
    T0 = torch.empty((7,), dtype=torch.float32, device=dev)
    cuda.call("vsg_pnp_hypotheses", cuda.ptr(xw), cuda.ptr(uv),
              cuda.ptr(valid), cuda.ptr(cam_K), cuda.ptr(picks), M, H,
              float(np.float32(inlier_px * inlier_px)), cuda.ptr(poses),
              cuda.ptr(counts), cuda.ptr(T0), cuda.stream())
    pnp_hypotheses.launches += 1
    return T0, counts


pnp_hypotheses.launches = 0


def ransac_pnp(xw, uv, valid, cam_K, picks, inlier_px: float = 5.0,
               refine_iters: int = 10) -> PnPResult:
    """All-hypotheses PnP: the DLT RANSAC above, then the wide-gate
    pose-only GN (K6) over all matches from the winning pose."""
    T0, _ = pnp_hypotheses(xw, uv, valid, cam_K, picks, inlier_px)
    T, inl = pose_only_gn(T0, xw, uv, valid, cam_K, iters=refine_iters,
                          gate0=(4.0 * inlier_px) ** 2)
    return PnPResult(T, inl.sum(dtype=torch.int32), inl)
