"""Batched Sim3 RANSAC + nonlinear refinement between matched 3D point
sets (kernel K15, Sim3 half).

Port of ``visual_sgraphs_tpu/place/sim3_ransac.py`` (Sim3Solver.cc +
OptimizeSim3): H hypotheses, each a closed-form Horn solve on three
matches, scored by the metric inlier count; the best one polished by a
weighted Horn on its inliers (kept only if it loses no support); then five
Huber-IRLS Gauss-Newton steps on the 7-dof tangent with re-gating.

The JAX function draws its samples from a key; here they come in as an
explicit (n_hyp, 3) index tensor (``LoopCloser`` draws them, or a test
hands the reference's draws over).  ``refine_sim3_torch`` uses the
analytic Jacobian of r(xi) = exp(xi)·S·p_a - p_b at xi = 0,
[I, -[y]x, y] with y = S·p_a, which is what the reference's ``jacfwd``
through ``sim3_boxplus`` evaluates (the CPU tests hold the two together).

``verify_sim3`` runs RANSAC, polish and refinement as the hand kernel in
``csrc/sim3.cu`` (two launches) on CUDA tensors and the plain twin
``verify_sim3_torch`` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import geometry, lie


class Sim3Result(NamedTuple):
    S_ab: torch.Tensor  # (8,) Sim3 mapping frame-a points into frame-b
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # () int32


def _dist(S, p_a, p_b):
    return torch.linalg.norm(lie.sim3_apply(S, p_a) - p_b, dim=-1)


def ransac_sim3_torch(p_a, p_b, valid, samples, inlier_thresh: float = 0.10,
                      fix_scale: bool = False) -> Sim3Result:
    """RANSAC half: S_ab with p_b ~= S_ab · p_a from the hypotheses
    ``samples`` (n_hyp, 3), the first best on ties, then the polish."""
    idx = samples.long()
    S_hyp = geometry.horn_sim3(p_a[idx], p_b[idx], fix_scale=fix_scale)
    err = _dist(S_hyp[:, None, :], p_a[None], p_b[None])  # (H, M)
    inl = (err < inlier_thresh) & valid[None, :]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    w_best = inl[best].to(p_a.dtype)
    S_ref = geometry.horn_sim3(p_a, p_b, weights=w_best + 1e-9,
                               fix_scale=fix_scale)
    inl_ref = (_dist(S_ref, p_a, p_b) < inlier_thresh) & valid
    better = inl_ref.sum() >= counts[best]
    S_out = torch.where(better, S_ref, S_hyp[best])
    inl_out = torch.where(better, inl_ref, inl[best])
    return Sim3Result(S_out, inl_out, inl_out.sum(dtype=torch.int32))


def sim3_point_jacobian(S, p_a):
    """(M, 3, 7) d(exp(xi)·S·p_a)/d xi at xi = 0: [I, -[y]x, y]."""
    y = lie.sim3_apply(S, p_a)
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand(
        y.shape[0], 3, 3)
    return torch.cat([eye, -lie.hat(y), y[..., None]], dim=-1)


def refine_sim3_torch(S, p_a, p_b, valid, inlier_thresh: float = 0.10,
                      iters: int = 5, fix_scale: bool = False) -> Sim3Result:
    """Huber-IRLS Gauss-Newton refinement over all matches."""
    eye7 = torch.eye(7, dtype=S.dtype, device=S.device)
    for _ in range(iters):
        r = lie.sim3_apply(S, p_a) - p_b
        J = sim3_point_jacobian(S, p_a)
        d = torch.linalg.norm(r, dim=-1)
        w = torch.where(valid & (d < inlier_thresh * 3.0),
                        torch.clamp(inlier_thresh / torch.clamp(d, min=1e-9),
                                    max=1.0), 0.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("mri,mrj->ij", Jw, J)
        g = torch.einsum("mri,mr->i", Jw, r)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = torch.cat([g[:6], torch.zeros_like(g[6:])])
        dx = torch.linalg.solve(H + eye7 * 1e-5, -g)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        S = lie.sim3_normalize(lie.sim3_boxplus(S, dx))
    inl = (_dist(S, p_a, p_b) < inlier_thresh) & valid
    return Sim3Result(S, inl, inl.sum(dtype=torch.int32))


def verify_sim3_torch(p_a, p_b, valid, samples, inlier_thresh: float = 0.10,
                      fix_scale: bool = False,
                      refine_iters: int = 5) -> Sim3Result:
    """Plain twin of K15's Sim3 half: RANSAC, polish, refinement."""
    if p_a.is_cuda:
        verify_sim3_torch.cuda_calls += 1
    res = ransac_sim3_torch(p_a, p_b, valid, samples, inlier_thresh,
                            fix_scale)
    return refine_sim3_torch(res.S_ab, p_a, p_b, valid, inlier_thresh,
                             refine_iters, fix_scale)


verify_sim3_torch.cuda_calls = 0


def verify_sim3(p_a, p_b, valid, samples, inlier_thresh: float = 0.10,
                fix_scale: bool = False, refine_iters: int = 5) -> Sim3Result:
    """Sim3 RANSAC + refinement (kernel K15 on CUDA tensors, the twin on
    CPU)."""
    if p_a.device.type == "cpu":
        return verify_sim3_torch(p_a, p_b, valid, samples, inlier_thresh,
                                 fix_scale, refine_iters)
    cuda.require_cuda("verify_sim3", p_a, p_b, valid, samples)
    if p_a.dtype != torch.float32 or p_b.dtype != torch.float32 \
            or valid.dtype != torch.bool or samples.dtype != torch.int32:
        raise ValueError("verify_sim3: float32 points, bool mask, int32 "
                         "samples")
    M, H = p_a.shape[0], samples.shape[0]
    dev = p_a.device
    S_hyp = torch.empty((H, 8), dtype=torch.float32, device=dev)
    counts = torch.empty((H,), dtype=torch.int32, device=dev)
    S = torch.empty((8,), dtype=torch.float32, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    inliers = torch.empty((M,), dtype=torch.bool, device=dev)
    cuda.call("vsg_verify_sim3", cuda.ptr(p_a), cuda.ptr(p_b),
              cuda.ptr(valid), cuda.ptr(samples), M, H,
              float(np.float32(inlier_thresh)), int(fix_scale),
              int(refine_iters), cuda.ptr(S_hyp), cuda.ptr(counts),
              cuda.ptr(S), cuda.ptr(n_inl), cuda.ptr(inliers), cuda.stream())
    verify_sim3.launches += 1
    return Sim3Result(S, inliers, n_inl)


verify_sim3.launches = 0
