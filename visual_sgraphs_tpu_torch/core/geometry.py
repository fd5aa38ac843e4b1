"""Horn alignment and the absolute trajectory error.

Port of ``horn_sim3`` and ``ate_rmse`` from
``visual_sgraphs_tpu/core/geometry.py`` — the closed-form alignment of the
evaluation harness (evaluation/evaluate_ate_scale.py).
"""

from __future__ import annotations

import torch

from visual_sgraphs_tpu_torch.core import lie


def horn_sim3(src, dst, weights=None, fix_scale: bool = False):
    """Closed-form similarity alignment; returns Sim3 (..., 8) src -> dst."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                              min=1e-12)
    mu_s = torch.sum(w[..., None] * src, dim=-2)
    mu_d = torch.sum(w[..., None] * dst, dim=-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    W = torch.einsum("...n,...ni,...nj->...ij", w, dc, sc)
    U, S, Vt = torch.linalg.svd(W)
    det = torch.linalg.det(U @ Vt)
    D = torch.zeros(W.shape[:-2] + (3, 3), dtype=W.dtype, device=W.device)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    D[..., 2, 2] = det
    R = U @ D @ Vt
    if fix_scale:
        s = torch.ones(W.shape[:-2], dtype=W.dtype, device=W.device)
    else:
        var_s = torch.sum(w * torch.sum(sc * sc, dim=-1), dim=-1)
        trace_DS = S[..., 0] + S[..., 1] + det * S[..., 2]
        s = trace_DS / torch.clamp(var_s, min=1e-12)
    t = mu_d - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s)
    q = lie.matrix_to_quat(R)
    return torch.cat([q, t, s[..., None]], dim=-1)


def ate_rmse(est, gt, with_scale: bool = False):
    """Absolute trajectory error after Horn alignment.  ``est``/``gt``:
    (N, 3).  Returns (rmse, Sim3)."""
    S = horn_sim3(est, gt, fix_scale=not with_scale)
    aligned = lie.sim3_apply(S, est)
    err2 = torch.sum((aligned - gt) ** 2, dim=-1)
    return torch.sqrt(torch.mean(err2)), S
