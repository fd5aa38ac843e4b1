"""Levenberg-Marquardt solver with Schur elimination over a dense reduced
system.

Port of ``visual_sgraphs_tpu/optim/solve.py`` (g2o's SparseOptimizer +
BlockSolver + LM for the reference's ``Optimizer.cc`` solves):

- the reduced tangent space (every family but the eliminated one) is one
  dense vector of dimension D, its Hessian a dense (D, D) matrix
  assembled by block scatter-add (``index_put_`` with accumulation);
- the eliminated family (landmarks) contributes through the Schur
  complement ``S = H - Bᵀ B`` with ``B = L⁻¹ P`` and ``Hxx = L Lᵀ``;
- every LM step is computed and accepted on the device: the Cholesky
  factorisations are ``torch.linalg.cholesky_ex`` (a failed one zeroes its
  step, as the reference's NaNs do through its ``isfinite`` mask, and
  nothing is read back), and accept / reject is a ``torch.where``.

``optimize`` takes optional ``assemble`` / ``cost`` callables that replace
the generic linearisation and cost of the problem's factors (the pose
graph passes its kernel K19 there, ``place/pgo.py``); its schedule,
``lm_loop``, also runs the kernel route's steps (``optim/lm_kernels.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from visual_sgraphs_tpu_torch.optim.graph import (
    GraphProblem,
    batch_chi2,
    linearize_batch,
)


@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    values: Mapping[str, torch.Tensor]  # optimised per-family tables
    cost: torch.Tensor  # final robust cost
    initial_cost: torch.Tensor
    lam: torch.Tensor  # final damping
    accepted: torch.Tensor  # (iters,) bool history


def _with_values(problem: GraphProblem, values) -> dict:
    return {k: dataclasses.replace(problem.families[k], values=values[k])
            for k in problem.families}


def _family_col_indices(problem: GraphProblem, name: str, idx):
    """Global reduced-tangent columns (m, t) of rows ``idx`` of a family."""
    t = problem.families[name].tangent_dim
    return (problem.offsets()[name] + idx.long()[:, None] * t
            + torch.arange(t, device=idx.device)[None, :])


def _huber_cost(chi2, delta: float | None):
    if delta is None:
        return chi2
    d2 = delta * delta
    return torch.where(chi2 <= d2, chi2, 2.0 * delta * torch.sqrt(
        torch.clamp(chi2, min=1e-12)) - d2)


def problem_cost(problem: GraphProblem, values) -> torch.Tensor:
    """Total robust cost at ``values``."""
    fams = _with_values(problem, values)
    ref = next(iter(values.values()))
    total = torch.zeros((), dtype=ref.dtype, device=ref.device)
    for batch in problem.factors:
        chi2 = batch_chi2(batch, fams)
        total = total + torch.sum(
            torch.where(batch.valid, _huber_cost(chi2, batch.huber), 0.0))
    return total


def _assemble(problem: GraphProblem, values):
    """Linearise every factor batch and scatter into the dense reduced
    system plus the eliminated family's block-diagonal system.  Returns
    (H, g, Hxx, bx, P); the last three are None without elimination."""
    fams = _with_values(problem, values)
    D = problem.reduced_dim()
    ref = next(iter(values.values()))
    dtype, dev = ref.dtype, ref.device
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    g = torch.zeros((D,), dtype=dtype, device=dev)
    elim = problem.eliminated
    if elim is not None:
        ef = problem.families[elim]
        N, te = ef.n, ef.tangent_dim
        Hxx = torch.zeros((N, te, te), dtype=dtype, device=dev)
        bx = torch.zeros((N, te), dtype=dtype, device=dev)
        P = torch.zeros((N * te, D), dtype=dtype, device=dev)
        ar_e = torch.arange(te, device=dev)
    else:
        Hxx = bx = P = None

    for batch in problem.factors:
        r, jacs, w = linearize_batch(batch, fams)
        names = batch.families
        for i, ni in enumerate(names):
            Ji = jacs[i]
            idx_i = batch.var_idx[:, i].long()
            gi = torch.einsum("mri,mr->mi", Ji, r) * w[:, None]
            if ni == elim:
                bx.index_put_((idx_i,), gi, accumulate=True)
            else:
                g.index_put_((_family_col_indices(problem, ni, idx_i),), gi,
                             accumulate=True)
            for j in range(i, len(names)):
                nj = names[j]
                idx_j = batch.var_idx[:, j].long()
                block = torch.einsum("mri,mrj->mij", Ji, jacs[j]) \
                    * w[:, None, None]
                if ni == elim and nj == elim:
                    Hxx.index_put_((idx_i,), block, accumulate=True)
                elif ni == elim:
                    cols_j = _family_col_indices(problem, nj, idx_j)
                    rows_e = idx_i[:, None] * te + ar_e[None, :]
                    P.index_put_((rows_e[:, :, None], cols_j[:, None, :]),
                                 block, accumulate=True)
                elif nj == elim:
                    cols_i = _family_col_indices(problem, ni, idx_i)
                    rows_e = idx_j[:, None] * te + ar_e[None, :]
                    P.index_put_((rows_e[:, :, None], cols_i[:, None, :]),
                                 block.transpose(-1, -2), accumulate=True)
                else:
                    cols_i = _family_col_indices(problem, ni, idx_i)
                    cols_j = _family_col_indices(problem, nj, idx_j)
                    H.index_put_((cols_i[:, :, None], cols_j[:, None, :]),
                                 block, accumulate=True)
                    if i != j:
                        H.index_put_(
                            (cols_j[:, :, None], cols_i[:, None, :]),
                            block.transpose(-1, -2), accumulate=True)
    return H, g, Hxx, bx, P


def _reduced_fixed_mask(problem: GraphProblem) -> torch.Tensor:
    parts = [(~problem.families[k].fixed).repeat_interleave(
        problem.families[k].tangent_dim) for k in problem.reduced_names()]
    if not parts:
        return torch.zeros((0,), dtype=torch.bool)
    return torch.cat(parts)


def _cholesky(A):
    """Lower Cholesky factor and a device flag: True where it succeeded."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, info == 0


def _solve_step(problem: GraphProblem, values, lam, free_mask,
                assemble: Callable | None = None):
    """One damped Gauss-Newton step: per-family deltas."""
    if assemble is None:
        H, g, Hxx, bx, P = _assemble(problem, values)
    else:
        (H, g), Hxx, bx, P = assemble(values), None, None, None
    D = H.shape[0]
    dtype = H.dtype
    eps = 1e-8 if dtype == torch.float64 else 1e-5
    diag = torch.clamp(torch.diagonal(H), min=1e-6)
    H = H + torch.diag(lam * diag + eps)

    elim = problem.eliminated
    if elim is not None:
        ef = problem.families[elim]
        te = ef.tangent_dim
        dHxx = torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-6)
        Hxx = Hxx + (lam * dHxx + eps)[..., None] * torch.eye(
            te, dtype=dtype, device=H.device)
        L, L_ok = _cholesky(Hxx)
        P3 = P.reshape(ef.n, te, D)
        B = torch.linalg.solve_triangular(L, P3, upper=False)
        c = torch.linalg.solve_triangular(L, bx[..., None], upper=False)[
            ..., 0]
        S = H - torch.einsum("nrd,nre->de", B, B)
        rhs = -g + torch.einsum("nrd,nr->d", B, c)
    else:
        S, rhs = H, -g

    fm = free_mask.to(dtype)
    S = S * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    rhs = rhs * fm
    Ls, ok = _cholesky(S)
    dxr = torch.cholesky_solve(rhs[:, None], Ls)[:, 0]
    dxr = torch.where(torch.isfinite(dxr) & ok, dxr, 0.0) * fm

    deltas = {}
    offs = problem.offsets()
    for k in problem.reduced_names():
        fam = problem.families[k]
        t = fam.tangent_dim
        deltas[k] = dxr[offs[k]:offs[k] + fam.n * t].reshape(fam.n, t)
    if elim is not None:
        # dx_x = -Hxx^-1 (bx + P dxr) = -L^-T (c + B dxr)
        y = c + torch.einsum("nrd,d->nr", B, dxr)
        dxe = -torch.linalg.solve_triangular(
            L.transpose(-1, -2), y[..., None], upper=True)[..., 0]
        dxe = torch.where(torch.isfinite(dxe) & L_ok[:, None], dxe, 0.0)
        deltas[elim] = torch.where(ef.fixed[:, None], 0.0, dxe)
    return deltas


def _retract_all(problem: GraphProblem, values, deltas):
    return {k: fam.retract(values[k],
                           torch.where(fam.fixed[:, None], 0.0, deltas[k]))
            for k, fam in problem.families.items()}


def lm_loop(values: dict, cost0, iters: int, step: Callable,
            lam_dtype=None) -> OptimizeResult:
    """The engine's LM schedule: ``iters`` iterations from ``values`` (a
    dict of tables) at cost ``cost0``, each ``step(values, lam) ->
    (candidate values, candidate cost)`` accepted when the candidate's cost
    is lower and finite; lambda starts at 1e-4, halves on accept and grows
    x10 on reject, clamped to [1e-10, 1e6]; every decision on the device.
    lambda is a device scalar of ``lam_dtype`` (the cost's dtype when
    None)."""
    lam = torch.full((), 1e-4, dtype=lam_dtype or cost0.dtype,
                     device=cost0.device)
    cur = cost0
    history = []
    for _ in range(iters):
        cand, cand_cost = step(values, lam)
        accept = (cand_cost < cur) & torch.isfinite(cand_cost)
        values = {k: torch.where(accept, cand[k], values[k]) for k in values}
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0),
                          1e-10, 1e6)
        cur = torch.where(accept, cand_cost, cur)
        history.append(accept)
    return OptimizeResult(values=values, cost=cur, initial_cost=cost0,
                          lam=lam, accepted=torch.stack(history) if history
                          else torch.zeros((0,), dtype=torch.bool))


def optimize(problem: GraphProblem, iters: int = 10,
             assemble: Callable | None = None,
             cost: Callable | None = None) -> OptimizeResult:
    """``iters`` LM iterations on a fixed schedule (the reference's
    budgets, ``lm_loop``), each accepted or rejected on the device.
    ``assemble(values) -> (H, g)`` / ``cost(values) -> ()`` replace the
    generic linearisation and cost (no eliminated family then)."""
    cost_fn = cost or (lambda v: problem_cost(problem, v))
    values = {k: f.values for k, f in problem.families.items()}
    free_mask = _reduced_fixed_mask(problem).to(
        next(iter(values.values())).device)

    def step(values, lam):
        deltas = _solve_step(problem, values, lam, free_mask, assemble)
        cand = _retract_all(problem, values, deltas)
        return cand, cost_fn(cand)

    return lm_loop(values, cost_fn(values), iters, step)
