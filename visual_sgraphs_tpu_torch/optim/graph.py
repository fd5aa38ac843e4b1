"""Factor-graph problem representation: variable families + factor batches.

Port of ``visual_sgraphs_tpu/optim/graph.py``.  A problem is a set of
fixed-capacity variable families (keyframe poses, planes, velocities and
IMU biases as point families, gravity directions, scales ...) with
validity / fixed masks, and factor batches (all factors of one type,
a residual function evaluated per item on gathered variable rows plus
per-item constants).  Jacobians are forward-mode autodiff through each
family's retraction at delta = 0 (``torch.func.jacfwd`` under
``torch.func.vmap``, the reference's ``jax.jacfwd`` + ``vmap``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.func import jacfwd, vmap

from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.core import plane as plane_mod


@dataclasses.dataclass(frozen=True)
class VarFamily:
    """A fixed-capacity table of variables of one geometric type."""

    values: torch.Tensor  # (n, store_dim)
    fixed: torch.Tensor  # (n,) bool, excluded from the update
    tangent_dim: int
    retract: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    @property
    def n(self) -> int:
        return self.values.shape[0]


def _fixed_or_none(values, fixed):
    if fixed is None:
        return torch.zeros(values.shape[0], dtype=torch.bool,
                           device=values.device)
    return fixed


def se3_family(values, fixed=None) -> VarFamily:
    return VarFamily(values, _fixed_or_none(values, fixed), 6,
                     lie.se3_boxplus)


def _add_delta(v, d):
    return v + d


def point_family(values, fixed=None) -> VarFamily:
    return VarFamily(values, _fixed_or_none(values, fixed), 3, _add_delta)


def plane_family(values, fixed=None) -> VarFamily:
    """Planes with the 3-dof azimuth/elevation/distance chart."""
    return VarFamily(values, _fixed_or_none(values, fixed), 3,
                     plane_mod.oplus)


def sim3_family(values, fixed=None) -> VarFamily:
    return VarFamily(values, _fixed_or_none(values, fixed), 7,
                     lie.sim3_boxplus)


def gdir_family(values, fixed=None) -> VarFamily:
    """Gravity directions (unit quaternions R_wg) with the 2-dof chart of
    the inertial initialisation."""
    from visual_sgraphs_tpu_torch.inertial.factors import gdir_retract
    return VarFamily(values, _fixed_or_none(values, fixed), 2, gdir_retract)


def scale_family(values, fixed=None) -> VarFamily:
    """Scales (n, 1) with the multiplicative 1-dof chart s exp(d)."""
    from visual_sgraphs_tpu_torch.inertial.factors import scale_retract
    return VarFamily(values, _fixed_or_none(values, fixed), 1,
                     scale_retract)


@dataclasses.dataclass(frozen=True)
class FactorBatch:
    """All factors of one type, as a batch of m items.
    ``residual_fn(values: tuple, const: dict) -> (res_dim,)`` receives one
    gathered row per connected family and this item's constants."""

    families: tuple
    residual_fn: Callable[..., torch.Tensor]
    res_dim: int
    var_idx: torch.Tensor  # (m, len(families)) rows into each family
    const: Any  # dict of tensors with leading dim m
    info: torch.Tensor  # (m,) or (m, res_dim) information weights
    valid: torch.Tensor  # (m,) bool
    huber: float | None = None  # Huber width in whitened units

    @property
    def m(self) -> int:
        return self.var_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class GraphProblem:
    """A least-squares problem over named variable families; at most one
    family (the landmarks) is ``eliminated`` from the dense system."""

    families: Mapping[str, VarFamily]
    factors: Sequence[FactorBatch]
    eliminated: str | None = None

    def reduced_names(self) -> tuple:
        return tuple(k for k in self.families if k != self.eliminated)

    def reduced_dim(self) -> int:
        return sum(self.families[k].n * self.families[k].tangent_dim
                   for k in self.reduced_names())

    def offsets(self) -> dict:
        off, out = 0, {}
        for k in self.reduced_names():
            out[k] = off
            off += self.families[k].n * self.families[k].tangent_dim
        return out


def linearize_batch(batch: FactorBatch, families: Mapping[str, VarFamily]):
    """Whitened residuals and per-family Jacobians of every item.

    Returns ``(r (m, res_dim), jacs tuple of (m, res_dim, t_k), w (m,))``
    where ``w`` folds validity and the Huber weight.  Calls on CUDA
    tensors are counted in ``linearize_batch.cuda_calls``: the card's
    paths linearise in kernels (K21, K22)."""
    if batch.var_idx.is_cuda:
        linearize_batch.cuda_calls += 1
    fams = [families[name] for name in batch.families]
    gathered = tuple(f.values[batch.var_idx[:, i].long()]
                     for i, f in enumerate(fams))
    dtype = fams[0].values.dtype
    zeros = tuple(torch.zeros((batch.m, f.tangent_dim), dtype=dtype,
                              device=f.values.device) for f in fams)

    def item_residual(deltas, values, const):
        retracted = tuple(f.retract(v, d)
                          for f, v, d in zip(fams, values, deltas))
        return batch.residual_fn(retracted, const)

    def item_lin(deltas, values, const):
        return (item_residual(deltas, values, const),
                jacfwd(item_residual)(deltas, values, const))

    r, jacs = vmap(item_lin)(zeros, gathered, batch.const)
    # a Python-scalar branch of torch.where (e.g. the projection's depth
    # floor) gives a float64 tangent under forward AD: keep r's dtype
    jacs = tuple(j.to(r.dtype) for j in jacs)

    sqrt_info = torch.sqrt(batch.info)
    if batch.info.ndim == 1:
        r = r * sqrt_info[:, None]
        jacs = tuple(j * sqrt_info[:, None, None] for j in jacs)
    else:
        r = r * sqrt_info
        jacs = tuple(j * sqrt_info[..., None] for j in jacs)
    chi2 = torch.sum(r * r, dim=-1)
    w = torch.where(batch.valid, 1.0, 0.0).to(r.dtype)
    if batch.huber is not None:
        s = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = w * torch.clamp(batch.huber / s, max=1.0)
    return r, jacs, w


linearize_batch.cuda_calls = 0


def batch_chi2(batch: FactorBatch, families: Mapping[str, VarFamily]):
    """Per-item whitened squared residual (no Huber)."""
    fams = [families[name] for name in batch.families]
    gathered = tuple(f.values[batch.var_idx[:, i].long()]
                     for i, f in enumerate(fams))
    r = vmap(lambda vals, c: batch.residual_fn(vals, c))(gathered,
                                                         batch.const)
    if batch.info.ndim == 1:
        return batch.info * torch.sum(r * r, dim=-1)
    return torch.sum(batch.info * r * r, dim=-1)
