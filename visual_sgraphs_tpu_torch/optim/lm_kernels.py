"""The kernel route of the LM engine for the inertial keyframe path's
solves: the VI local BA, the generic windowed local BA and the inertial
initialisation.

Port of the reference's ``optim/solve.py:85::_assemble``,
``:158::_solve_step`` and ``:233::optimize`` for the problems those three
solves pose (``inertial/vi_ba.py:86``, ``slam/mapping.py:393``,
``inertial/init.py:54``): reprojection factors to Schur-eliminated points,
preintegration, bias-walk and bias-prior factors, and a dense reduced
system over at most the families [pose (6) | vel (3) | bg (3) | ba (3) |
gdir (2) | scale (1)].  Three hand-written kernels carry an iteration:

- K22a (``csrc/lm_reproj.cu``): ``lm_reproj_plan`` groups the used rows
  by landmark once a solve; ``lm_reproj_reduce`` then linearises the
  reprojection rows analytically (the left perturbation exp(xi) T of
  ``se3_boxplus``), landmark by landmark, accumulates each landmark's Hxx,
  bx and its 3 x 6 blocks P per window slot, damps Hxx by lambda as
  ``_solve_step`` does and reduces it into the pair sums sum B_a^T B_b (B =
  L^-1 P, Hxx = L L^T) and their rhs, beside the undamped pose-diagonal
  blocks of H and g, in one launch summed in an order fixed by the data;
  ``lm_reproj_cost`` back-substitutes the points at a step and sums the
  robust cost of the rows at the candidate, in one launch over the same
  plan, summed in an order fixed by the data;
- K22b (``csrc/lm_inertial.cu``): ``lm_inertial_plan`` whitens every
  edge and indexes the valid edges once a solve; ``lm_inertial_assemble``
  then adds the preintegration rows (``imu_factor`` with Huber 9, or
  ``imu_factor_gs``), the bias walks and the bias priors to the same dense
  H, g, in one launch summed in edge order; ``lm_inertial_cost`` sums
  their cost at the candidate;
- K22c (``csrc/lm_solve.cu``): ``lm_solve`` damps H, subtracts the pair
  sums, applies the gauge mask, solves by Cholesky and retracts every
  reduced family into candidate tables.

Each wrapper launches its kernel on CUDA tensors (counted in
``wrapper.launches``) and runs its plain twin, beside it here, on CPU
tensors: analytic rows, the per-landmark reduction and the dense solve in
the values' dtype (K22b's twin is the generic ``graph.linearize_batch``
on the inertial factor batches, as K21's is).  ``optimize_reproj_inertial``
runs these steps on the generic engine's own schedule (``solve.lm_loop``:
lambda0 = 1e-4, x0.5 on accept, x10 on reject, clamped to [1e-10, 1e6],
accept when the candidate cost is lower and finite), every decision on the
device.  The kernels solve and sum the cost in float64 (see their
headers); the twins in the values' dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from visual_sgraphs_tpu_torch import cuda
from visual_sgraphs_tpu_torch.core import lie
from visual_sgraphs_tpu_torch.optim.graph import (
    FactorBatch,
    GraphProblem,
    batch_chi2,
    gdir_family,
    point_family,
    scale_family,
    se3_family,
)
from visual_sgraphs_tpu_torch.optim.solve import (
    _assemble,
    _huber_cost,
    lm_loop,
)

HUBER_MONO = math.sqrt(5.991)
HUBER_STEREO = math.sqrt(7.815)
HUBER_IMU = 9.0
# the reduced families in layout order, with their tangent dimensions
FAMILIES = ("pose", "vel", "bg", "ba", "gdir", "scale")
TANGENT = {"pose": 6, "vel": 3, "bg": 3, "ba": 3, "gdir": 2, "scale": 1}


def _eps(dtype) -> float:
    """The engine's absolute damping (``_solve_step``)."""
    return 1e-8 if dtype == torch.float64 else 1e-5


class ReprojRows(NamedTuple):
    """A window's reprojection rows, one per (window slot, keypoint)."""

    slot: torch.Tensor  # (M,) int32 window row of the keyframe
    pt: torch.Tensor  # (M,) int32 local landmark row
    uvr: torch.Tensor  # (M, 3) observed (u, v, u_r); u_r on stereo rows
    use: torch.Tensor  # (M,) bool
    stereo: torch.Tensor  # (M,) bool: 3-row stereo factor, else 2-row mono


class Reduced(NamedTuple):
    """Values of the reduced families (None where a problem has none):
    pose (n, 7) T_cw, vel / bg / ba (n, 3), gdir (1, 4), scale (1, 1)."""

    pose: torch.Tensor | None = None
    vel: torch.Tensor | None = None
    bg: torch.Tensor | None = None
    ba: torch.Tensor | None = None
    gdir: torch.Tensor | None = None
    scale: torch.Tensor | None = None


class ImuRows(NamedTuple):
    """The inertial factors of a problem.  ``edge`` (E, 2) joins rows
    (i, j) of the pose and velocity families; ``pre`` (E, PACKED) is each
    edge's packed preintegration.  The VI BA (``gs`` False) has variable
    poses, per-slot biases (row j of an edge), gravity (0, 0, -9.81), Huber
    9 and bias walks of information ``info_g`` / ``info_a`` (E,); the
    initialisation (``gs`` True) has constant ``poses`` (n, 7), one shared
    bias, gravity direction and scale, no Huber, and bias priors of
    information ``prior`` with mean 0."""

    pre: torch.Tensor
    edge: torch.Tensor
    valid: torch.Tensor
    T_bc: torch.Tensor
    gs: bool
    info_g: torch.Tensor | None = None
    info_a: torch.Tensor | None = None
    poses: torch.Tensor | None = None
    prior: float = 0.0


class LmResult(NamedTuple):
    red: Reduced  # optimised reduced families
    pts: torch.Tensor | None  # optimised points
    cost: torch.Tensor  # final robust cost, in the values' dtype
    initial_cost: torch.Tensor
    lam: torch.Tensor
    accepted: torch.Tensor  # (iters,) bool


def offsets(red: Reduced) -> dict:
    """Column offset of each present family in the reduced vector."""
    off, out = 0, {}
    for k in FAMILIES:
        v = getattr(red, k)
        if v is not None:
            out[k] = off
            off += v.shape[0] * TANGENT[k]
    out["D"] = off
    return out


def free_mask(red: Reduced, fixed: dict) -> torch.Tensor:
    """(D,) bool: True on the columns of non-fixed rows (``fixed`` maps a
    family to its (n,) bool mask; absent means all free)."""
    parts = []
    for k in FAMILIES:
        v = getattr(red, k)
        if v is None:
            continue
        f = fixed.get(k)
        if f is None:
            f = torch.zeros((v.shape[0],), dtype=torch.bool, device=v.device)
        parts.append((~f).repeat_interleave(TANGENT[k]))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# K22a: reprojection rows and the landmark Schur reduction
# ---------------------------------------------------------------------------


def _reproj_residual(poses, pts, rows: ReprojRows, cam, bf):
    """Per row: the camera-frame point p (M, 3), the residual r (M, 3)
    (third entry 0 on mono rows) and the projection's Jacobian d r / d p
    (M, 3, 3), with the depth floors' zero derivatives."""
    T = poses[rows.slot.long()]
    X = pts[rows.pt.long()]
    p = lie.se3_apply(T, X)
    fx, fy, cx, cy = cam[0], cam[1], cam[2], cam[3]
    x, y, z = p.unbind(-1)
    tiny = torch.abs(z) < 1e-9
    iz = 1.0 / torch.where(tiny, 1e-9, z)
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    zc = torch.clamp(z, min=1e-6)
    ur = u - bf / zc
    r = torch.stack([u - rows.uvr[:, 0], v - rows.uvr[:, 1],
                     torch.where(rows.stereo, ur - rows.uvr[:, 2], 0.0)],
                    dim=-1)
    dinv = torch.where(tiny, 0.0, iz * iz)
    zero = torch.zeros_like(z)
    du = torch.stack([fx * iz, zero, -fx * x * dinv], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * dinv], dim=-1)
    dz_ur = torch.where(z > 1e-6, bf / (zc * zc), 0.0)
    dur = torch.stack([du[:, 0], zero, du[:, 2] + dz_ur], dim=-1)
    dur = torch.where(rows.stereo[:, None], dur, 0.0)
    return T, p, r, torch.stack([du, dv, dur], dim=1)


class ReprojState(NamedTuple):
    """The twin's per-landmark reduction, kept for the back-substitution."""

    L: torch.Tensor  # (N, 3, 3) Cholesky factor of the damped Hxx
    ok: torch.Tensor  # (N,) bool
    B: torch.Tensor  # (N, 3, 6L) L^-1 P
    c: torch.Tensor  # (N, 3) L^-1 bx


def lm_reproj_reduce_torch(poses, pts, rows: ReprojRows, cam, bf, lam,
                           D: int, plan: ReprojPlan | None = None):
    """Plain twin of K22a's linearise-and-reduce entry (``plan``, the
    kernel's row grouping, is not needed here).  Returns (H (D, D)
    with the undamped pose-diagonal blocks sum w Jp^T Jp in its top-left
    6L x 6L corner, g (D,) with sum w Jp^T r, pairs (6L, 6L) = sum_n
    B_n^T B_n, rhs (6L,) = sum_n B_n^T c_n, state), where Hxx_n = sum w
    Jx^T Jx is damped by lam clamp(diag, 1e-6) + eps before its Cholesky
    factor L_n, B_n = L_n^-1 P_n and c_n = L_n^-1 sum w Jx^T r."""
    if poses.is_cuda:
        lm_reproj_reduce_torch.cuda_calls += 1
    L, N = poses.shape[0], pts.shape[0]
    dtype, dev = poses.dtype, poses.device
    T, p, r, Jproj = _reproj_residual(poses, pts, rows, cam, bf)
    chi2 = torch.sum(r * r, dim=-1)
    huber = torch.where(rows.stereo, torch.full_like(chi2, HUBER_STEREO),
                        torch.full_like(chi2, HUBER_MONO))
    # the engine's ``huber / s`` with a Python scalar is reciprocal(s) * huber
    w = torch.where(rows.use, torch.clamp(torch.reciprocal(torch.sqrt(
        torch.clamp(chi2, min=1e-12))) * huber, max=1.0), 0.0)
    # d p / d xi = [I | -hat(p)] for exp(xi) T; d p / d X = R
    Jp = torch.cat([Jproj, -Jproj @ lie.hat(p)], dim=-1)
    Jx = Jproj @ lie.quat_to_matrix(T[:, :4])
    wJx = w[:, None, None] * Jx
    slot, pt = rows.slot.long(), rows.pt.long()
    Hxx = torch.zeros((N, 3, 3), dtype=dtype, device=dev).index_add_(
        0, pt, wJx.transpose(1, 2) @ Jx)
    bx = torch.zeros((N, 3), dtype=dtype, device=dev).index_add_(
        0, pt, torch.einsum("mri,mr->mi", wJx, r))
    P = torch.zeros((N * L, 3, 6), dtype=dtype, device=dev).index_add_(
        0, pt * L + slot, wJx.transpose(1, 2) @ Jp)
    wJp = w[:, None, None] * Jp
    Hpp = torch.zeros((L, 6, 6), dtype=dtype, device=dev).index_add_(
        0, slot, wJp.transpose(1, 2) @ Jp)
    gp = torch.zeros((L, 6), dtype=dtype, device=dev).index_add_(
        0, slot, torch.einsum("mri,mr->mi", wJp, r))
    blocks = torch.zeros((L, 6, L, 6), dtype=dtype, device=dev)
    idx = torch.arange(L, device=dev)
    blocks[idx, :, idx, :] = Hpp
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    H[:6 * L, :6 * L] = blocks.reshape(6 * L, 6 * L)
    g = torch.zeros((D,), dtype=dtype, device=dev)
    g[:6 * L] = gp.reshape(-1)

    dHxx = torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-6)
    Hxx = Hxx + (lam * dHxx + _eps(dtype))[..., None] * torch.eye(
        3, dtype=dtype, device=dev)
    Lc, info = torch.linalg.cholesky_ex(Hxx)
    P3 = P.reshape(N, L, 3, 6).permute(0, 2, 1, 3).reshape(N, 3, 6 * L)
    B = torch.linalg.solve_triangular(Lc, P3, upper=False)
    c = torch.linalg.solve_triangular(Lc, bx[..., None], upper=False)[..., 0]
    pairs = torch.einsum("nrd,nre->de", B, B)
    rhs = torch.einsum("nrd,nr->d", B, c)
    return H, g, pairs, rhs, ReprojState(Lc, info == 0, B, c)


lm_reproj_reduce_torch.cuda_calls = 0


class ReprojPlan(NamedTuple):
    """The used rows of a solve grouped by landmark, in row order (CSR)."""

    ptr: torch.Tensor  # (N + 1,) int32 landmark n's rows: idx[ptr[n]:ptr[n+1]]
    idx: torch.Tensor  # (M,) int32 row indices, -1 past ptr[N]


def lm_reproj_plan_torch(rows: ReprojRows, N: int) -> ReprojPlan:
    """Plain twin of K22a's plan: the rows with ``use`` and a landmark id
    in [0, N), stably sorted by landmark."""
    if rows.pt.is_cuda:
        lm_reproj_plan_torch.cuda_calls += 1
    M, dev = rows.pt.shape[0], rows.pt.device
    pt = rows.pt.long()
    key = torch.where(rows.use & (pt >= 0) & (pt < N), pt, N)
    order = torch.sort(key, stable=True).indices
    ptr = torch.zeros((N + 1,), dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(key, minlength=N + 1)[:N], 0)
    idx = torch.where(torch.arange(M, device=dev) < ptr[N], order, -1)
    return ReprojPlan(ptr.to(torch.int32), idx.to(torch.int32))


lm_reproj_plan_torch.cuda_calls = 0


def lm_reproj_plan(rows: ReprojRows, N: int) -> ReprojPlan:
    """K22a's row plan (one launch of one CTA on CUDA tensors, the twin on
    CPU tensors); built once a solve, as ``lm_reproj_plan_torch``."""
    if rows.pt.device.type == "cpu":
        return lm_reproj_plan_torch(rows, N)
    cuda.require_cuda("lm_reproj_plan", rows.pt, rows.use)
    if rows.pt.dtype != torch.int32 or rows.use.dtype != torch.bool:
        raise ValueError("lm_reproj_plan: int32 ids, a bool mask")
    M, dev = rows.pt.shape[0], rows.pt.device
    ptr = torch.empty((N + 1,), dtype=torch.int32, device=dev)
    idx = torch.empty((M,), dtype=torch.int32, device=dev)
    cuda.call("vsg_lm_reproj_plan", cuda.ptr(rows.pt), cuda.ptr(rows.use), M,
              N, cuda.ptr(ptr), cuda.ptr(idx), cuda.stream())
    lm_reproj_plan.launches += 1
    return ReprojPlan(ptr, idx)


lm_reproj_plan.launches = 0


def _reproj_cost(poses, pts, rows: ReprojRows, cam, bf):
    """Robust cost of the rows: the mono rows' sum, then the stereo
    rows' (the engine's batch order)."""
    _, _, r, _ = _reproj_residual(poses, pts, rows, cam, bf)
    chi2 = torch.sum(r * r, dim=-1)
    mono = rows.use & ~rows.stereo
    stereo = rows.use & rows.stereo
    total = torch.zeros((), dtype=poses.dtype, device=poses.device)
    total = total + torch.sum(torch.where(
        mono, _huber_cost(chi2, HUBER_MONO), 0.0))
    return total + torch.sum(torch.where(
        stereo, _huber_cost(chi2, HUBER_STEREO), 0.0))


def lm_reproj_cost_torch(poses, pts, pt_fixed, rows: ReprojRows, cam, bf,
                         state: ReprojState | None = None, dx=None,
                         acc=None, plan: ReprojPlan | None = None):
    """Plain twin of K22a's back-substitute-and-cost entry (``plan``, the
    kernel's row grouping, is not needed here).  With a step
    ``dx`` (D,): the points' step -L^-T (c + B dx[:6L]) (zero where not
    finite, where the factorisation failed and on fixed points), the
    candidate points and the rows' robust cost at (``poses``, candidate
    points); without, the cost at (``poses``, ``pts``).  Returns (points,
    cost (+ ``acc``))."""
    if poses.is_cuda:
        lm_reproj_cost_torch.cuda_calls += 1
    if dx is not None:
        L = poses.shape[0]
        y = state.c + torch.einsum("nrd,d->nr", state.B, dx[:6 * L])
        dxe = -torch.linalg.solve_triangular(
            state.L.transpose(-1, -2), y[..., None], upper=True)[..., 0]
        dxe = torch.where(torch.isfinite(dxe) & state.ok[:, None], dxe, 0.0)
        pts = pts + torch.where(pt_fixed[:, None], 0.0, dxe)
    cost = _reproj_cost(poses, pts, rows, cam, bf)
    return pts, cost if acc is None else acc + cost


lm_reproj_cost_torch.cuda_calls = 0


def _reproj_args(poses, pts, rows: ReprojRows, cam, bf):
    cuda.require_cuda("lm_reproj", poses, pts, *rows, cam, bf)
    if (any(t.dtype != torch.float32 for t in (poses, pts, rows.uvr, cam,
                                               bf))
            or rows.slot.dtype != torch.int32 or rows.pt.dtype != torch.int32
            or rows.use.dtype != torch.bool
            or rows.stereo.dtype != torch.bool):
        raise ValueError("lm_reproj: float32 values, int32 indices, bool "
                         "masks")
    ptr = cuda.ptr
    return (ptr(poses), poses.shape[0], ptr(pts), pts.shape[0],
            ptr(rows.slot), ptr(rows.pt), ptr(rows.uvr), ptr(rows.use),
            ptr(rows.stereo), rows.slot.shape[0], ptr(cam), ptr(bf),
            HUBER_MONO, HUBER_STEREO)


class ReprojKernelState(NamedTuple):
    """K22a's per-landmark reduction, kept for the back-substitution."""

    Linv: torch.Tensor  # (N, 6) packed lower inverse Cholesky factor
    c: torch.Tensor  # (N, 3)
    P: torch.Tensor  # (N, L, 3, 6), defined at the slots of ``mask``
    mask: torch.Tensor  # (N, (L + 31) // 32) int32: a bit an observing slot


@functools.lru_cache(maxsize=64)
def _reduce_scratch_bytes(N: int, L: int) -> int:
    return cuda.query("vsg_lm_reproj_scratch_bytes", N, L)


def lm_reproj_reduce(poses, pts, rows: ReprojRows, cam, bf, lam, D: int,
                     plan: ReprojPlan | None = None):
    """K22a's linearise-and-reduce entry on CUDA tensors (H, g, pairs,
    rhs in float64; one launch, bitwise equal from launch to launch), the
    twin on CPU tensors; as ``lm_reproj_reduce_torch``.  ``plan`` is
    ``lm_reproj_plan(rows, N)``, built here when not given."""
    if poses.device.type == "cpu":
        return lm_reproj_reduce_torch(poses, pts, rows, cam, bf, lam, D)
    args = _reproj_args(poses, pts, rows, cam, bf)
    _check_lam("lm_reproj_reduce", lam)
    L, N, dev = poses.shape[0], pts.shape[0], poses.device
    part_bytes = _reduce_scratch_bytes(N, L)
    if part_bytes < 0:
        raise ValueError(f"lm_reproj_reduce: a window of {L} slots does "
                         "not fit the kernel's shared accumulator")
    if plan is None:
        plan = lm_reproj_plan(rows, N)
    cuda.require_cuda("lm_reproj_reduce", *plan)
    f64 = dict(dtype=torch.float64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    H = torch.empty((D, D), **f64)
    g = torch.empty((D,), **f64)
    pairs = torch.empty((6 * L, 6 * L), **f64)
    rhs = torch.empty((6 * L,), **f64)
    part = torch.empty((part_bytes // 8,), **f64)
    st = ReprojKernelState(torch.empty((N, 6), **f32),
                           torch.empty((N, 3), **f32),
                           torch.empty((N, L, 3, 6), **f32),
                           torch.empty((N, (L + 31) // 32), dtype=torch.int32,
                                       device=dev))
    ptr = cuda.ptr
    cuda.call("vsg_lm_reproj_reduce", *args, ptr(lam),
              _eps(torch.float32), D, ptr(plan.ptr), ptr(plan.idx), ptr(H),
              ptr(g), ptr(pairs), ptr(rhs), ptr(st.P), ptr(st.mask),
              ptr(st.Linv), ptr(st.c), ptr(part), cuda.stream())
    lm_reproj_reduce.launches += 1
    return H, g, pairs, rhs, st


lm_reproj_reduce.launches = 0


# landmarks a CTA of K22a's step-and-cost launch (csrc/lm_reproj.cu
# COST_LANDMARKS)
COST_LANDMARKS = 16


def cost_ctas(N: int) -> int:
    """The CTAs of K22a's step-and-cost launch over N landmarks: CTA b
    owns landmarks [b COST_LANDMARKS, min(N, (b + 1) COST_LANDMARKS)) and
    the plan's rows of those landmarks (at least one CTA, which writes the
    cost)."""
    return max(1, -(-N // COST_LANDMARKS))


def lm_reproj_cost(poses, pts, pt_fixed, rows: ReprojRows, cam, bf,
                   state=None, dx=None, acc=None,
                   plan: ReprojPlan | None = None):
    """K22a's back-substitute-and-cost entry on CUDA tensors (the cost in
    float64, added into ``acc`` when given; one launch, bitwise equal from
    launch to launch), the twin on CPU tensors; as
    ``lm_reproj_cost_torch``.  ``plan`` is the solve's
    ``lm_reproj_plan(rows, N)``, built here when not given."""
    if poses.device.type == "cpu":
        return lm_reproj_cost_torch(poses, pts, pt_fixed, rows, cam, bf,
                                    state, dx, acc)
    args = _reproj_args(poses, pts, rows, cam, bf)
    N, dev = pts.shape[0], poses.device
    if plan is None:
        plan = lm_reproj_plan(rows, N)
    cuda.require_cuda("lm_reproj_cost", pt_fixed, *plan,
                      *(() if acc is None else (acc,)))
    if ((acc is not None and acc.dtype != torch.float64)
            or (dx is not None and (dx.dtype != torch.float32
                                    or state is None))):
        raise ValueError("lm_reproj_cost: a float64 cost, a float32 step "
                         "with the reduction's state")
    out = torch.empty_like(pts) if dx is not None else pts
    G = cost_ctas(N)
    scratch = torch.empty((1 + G,), dtype=torch.float64, device=dev)
    cost = acc if acc is not None else scratch[0]
    ptr = cuda.ptr
    st = state if dx is not None else ReprojKernelState(None, None, None,
                                                        None)
    cuda.call("vsg_lm_reproj_cost", *args, ptr(plan.ptr), ptr(plan.idx),
              ptr(pt_fixed), ptr(st.Linv), ptr(st.c), ptr(st.P),
              ptr(st.mask), ptr(dx), ptr(out), COST_LANDMARKS, G,
              ptr(scratch) + 8, ptr(cost), int(acc is not None),
              cuda.stream())
    lm_reproj_cost.launches += 1
    return out, cost


lm_reproj_cost.launches = 0


# ---------------------------------------------------------------------------
# K22b: the inertial rows
# ---------------------------------------------------------------------------


def _preint_const(pre_packed, T_bc):
    from visual_sgraphs_tpu_torch.inertial.init import preint_const
    from visual_sgraphs_tpu_torch.inertial.preintegration import unpack
    const = preint_const(unpack(pre_packed))
    const["T_bc"] = T_bc.to(pre_packed.dtype).expand(pre_packed.shape[0], 7)
    return const


def _inertial_problem(imu: ImuRows, red: Reduced):
    """The inertial factors as a generic ``GraphProblem`` (K22b's twin),
    with the full family layout (the initialisation's constant poses as a
    fixed first family), and the number of leading columns the reduced
    layout leaves out."""
    from visual_sgraphs_tpu_torch.inertial import factors as ifac
    E = imu.edge.shape[0]
    dev, dtype = imu.pre.device, imu.pre.dtype
    e_i, e_j = imu.edge[:, 0], imu.edge[:, 1]
    const = _preint_const(imu.pre, imu.T_bc)
    ones = torch.ones((E,), dtype=dtype, device=dev)
    if not imu.gs:
        g_w = torch.zeros((E, 3), dtype=dtype, device=dev)
        g_w[:, 2:].fill_(-ifac.GRAVITY)
        const["g_w"] = g_w
        fams = {"kf": se3_family(red.pose), "vel": point_family(red.vel),
                "bg": point_family(red.bg), "ba": point_family(red.ba)}
        batches = [FactorBatch(
            ("kf", "kf", "vel", "vel", "bg", "ba"), ifac.imu_factor, 9,
            torch.stack([e_i, e_j, e_i, e_j, e_j, e_j], dim=1), const, ones,
            imu.valid, huber=HUBER_IMU)]
        for fam, info in (("bg", imu.info_g), ("ba", imu.info_a)):
            batches.append(FactorBatch(
                (fam, fam), ifac.bias_walk, 3,
                torch.stack([e_i, e_j], dim=1), {}, info, imu.valid))
        return GraphProblem(families=fams, factors=batches), 0
    n = imu.poses.shape[0]
    zeros = torch.zeros((E,), dtype=torch.int32, device=dev)
    fams = {"pose": se3_family(imu.poses), "vel": point_family(red.vel),
            "bg": point_family(red.bg), "ba": point_family(red.ba),
            "gdir": gdir_family(red.gdir), "scale": scale_family(red.scale)}
    one_idx = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    batches = [FactorBatch(
        ("pose", "pose", "vel", "vel", "bg", "ba", "gdir", "scale"),
        ifac.imu_factor_gs, 9, torch.stack(
            [e_i, e_j, e_i, e_j, zeros, zeros, zeros, zeros], dim=1), const,
        ones, imu.valid)]
    for fam in ("bg", "ba"):
        batches.append(FactorBatch(
            (fam,), ifac.prior_3, 3, one_idx,
            {"mean": torch.zeros((1, 3), dtype=dtype, device=dev)},
            torch.full((1,), imu.prior, dtype=dtype, device=dev),
            torch.ones((1,), dtype=torch.bool, device=dev)))
    return GraphProblem(families=fams, factors=batches), 6 * n


def lm_inertial_assemble_torch(imu: ImuRows, red: Reduced, H=None, g=None):
    """Plain twin of K22b's assembly: the inertial factor batches
    linearised generically (``graph.linearize_batch``) and scattered
    densely over the reduced layout, added to ``H``, ``g`` (zeros of the
    reduced dimension when None).  Returns (H, g)."""
    if imu.pre.is_cuda:
        lm_inertial_assemble_torch.cuda_calls += 1
    problem, skip = _inertial_problem(imu, red)
    values = {k: f.values for k, f in problem.families.items()}
    Hi, gi, _, _, _ = _assemble(problem, values)
    Hi, gi = Hi[skip:, skip:], gi[skip:]
    if H is None:
        return Hi, gi
    H[:Hi.shape[0], :Hi.shape[0]] += Hi.to(H.dtype)
    g[:Hi.shape[0]] += gi.to(g.dtype)
    return H, g


lm_inertial_assemble_torch.cuda_calls = 0


def lm_inertial_cost_torch(imu: ImuRows, red: Reduced, acc=None):
    """Plain twin of K22b's cost entry: the inertial batches' robust cost
    at ``red`` (+ ``acc``), summed in the engine's batch order."""
    if imu.pre.is_cuda:
        lm_inertial_cost_torch.cuda_calls += 1
    problem, _ = _inertial_problem(imu, red)
    total = acc if acc is not None else torch.zeros(
        (), dtype=imu.pre.dtype, device=imu.pre.device)
    for batch in problem.factors:
        chi2 = batch_chi2(batch, problem.families)
        if batch.huber is not None:
            chi2 = _huber_cost(chi2, batch.huber)
        total = total + torch.sum(torch.where(batch.valid, chi2, 0.0))
    return total


lm_inertial_cost_torch.cuda_calls = 0


def _check_lam(name, lam):
    cuda.require_cuda(name, lam)
    if lam.dtype != torch.float32 or lam.numel() != 1:
        raise ValueError(f"{name}: a float32 device scalar lambda")


def _check_values(name, red: Reduced):
    vals = [v for v in red if v is not None]
    cuda.require_cuda(name, *vals)
    if any(v.dtype != torch.float32 for v in vals):
        raise ValueError(f"{name}: float32 values")


class InertialPlan(NamedTuple):
    """K22b's constants of a solve: each edge's whitening and the index of
    the valid edges (``lm_inertial_plan``); on the card also the kernels'
    argument block (``args``; None from the twin)."""

    W: torch.Tensor  # (E, 81) float64 W = L^-1, L L^T = cov + 1e-8 I
    rptr: torch.Tensor  # (R + 1,) int32: row r's edges start at rptr[r]
    redge: torch.Tensor  # (2E,) int32 valid edges touching each row, -1 after
    vedge: torch.Tensor  # (E,) int32 the valid edges in order, -1 after
    nvalid: torch.Tensor  # (1,) int32
    args: object = None


# the rows launch keeps the plan's edge index in shared memory up to this
# size (beside its 18432 static bytes, under the 48 KB of a plain launch),
# else reads it from the plan's tensors; staging saves 1-3 % of the
# launch's device time at 9 and 100 edges (NVIDIA H100 80GB HBM3), and
# selfcheck.check_lm_inertial holds both sides (1500 edges reads global)
_IX_SHARED_BYTES = 28672


class _ImuSolve(ctypes.Structure):
    """csrc/lm_inertial.cu's ``ImuSolve``: the constants of a solve."""

    _fields_ = [(k, ctypes.c_void_p) for k in (
        "pre", "edge", "T_bc", "poses", "info_g", "info_a", "W", "rptr",
        "redge", "vedge", "nvalid", "jac", "grd")] + [
        ("E", ctypes.c_int), ("R", ctypes.c_int), ("gs", ctypes.c_int),
        ("D", ctypes.c_int), ("ix", ctypes.c_int), ("prior", ctypes.c_float),
        ("off", ctypes.c_int * 6)]


class _InertialArgs(NamedTuple):
    solve: _ImuSolve
    addr: int  # of ``solve``
    vals: ctypes.Array  # the six value pointers, filled each call
    shapes: tuple  # each family's expected shape (None absent)
    keep: tuple  # the tensors behind ``solve``'s pointers


def lm_inertial_plan_torch(imu: ImuRows, red: Reduced) -> InertialPlan:
    """Plain twin of K22b's plan: ``inertial.init.sqrt_info`` of every
    edge's covariance in float64, the valid edges (rows inside the
    layout) in order, and for each row of the per-slot families the valid
    edges with i or j on it, in edge order."""
    from visual_sgraphs_tpu_torch.inertial.init import sqrt_info
    from visual_sgraphs_tpu_torch.inertial.preintegration import unpack
    if imu.pre.is_cuda:
        lm_inertial_plan_torch.cuda_calls += 1
    E, R, dev = imu.edge.shape[0], red.vel.shape[0], imu.pre.device
    W = sqrt_info(unpack(imu.pre).cov.double()).reshape(E, 81)
    i, j = imu.edge.long().unbind(-1)
    ok = imu.valid & (i >= 0) & (i < R) & (j >= 0) & (j < R)
    i32 = dict(dtype=torch.int32, device=dev)
    vedge = torch.full((E,), -1, **i32)
    valid_ids = torch.nonzero(ok)[:, 0]
    vedge[:valid_ids.shape[0]] = valid_ids.to(torch.int32)
    rows = torch.arange(R, device=dev)[:, None]
    touch = ok[None, :] & ((i[None, :] == rows) | (j[None, :] == rows))
    rptr = torch.zeros((R + 1,), **i32)
    rptr[1:] = torch.cumsum(touch.sum(dim=1), 0)
    redge = torch.full((2 * E,), -1, **i32)
    listed = torch.nonzero(touch)[:, 1]
    redge[:listed.shape[0]] = listed.to(torch.int32)
    return InertialPlan(W, rptr, redge, vedge,
                        torch.full((1,), valid_ids.shape[0], **i32))


lm_inertial_plan_torch.cuda_calls = 0


def lm_inertial_plan(imu: ImuRows, red: Reduced) -> InertialPlan:
    """K22b's plan on CUDA tensors (one launch; built once a solve, as
    ``lm_inertial_plan_torch``, with the kernels' arguments and scratch),
    the twin on CPU tensors.  ``red`` fixes the layout: its values are
    not read."""
    if imu.pre.device.type == "cpu":
        return lm_inertial_plan_torch(imu, red)
    from visual_sgraphs_tpu_torch.inertial.preintegration import PACKED
    _check_values("lm_inertial_plan", red)
    gs = bool(imu.gs)
    extra = (imu.poses,) if gs else (imu.info_g, imu.info_a)
    cuda.require_cuda("lm_inertial_plan", imu.pre, imu.edge, imu.valid,
                      imu.T_bc, *extra)
    if (imu.pre.dtype != torch.float32 or imu.pre.shape[1] != PACKED
            or imu.edge.dtype != torch.int32 or imu.valid.dtype != torch.bool
            or any(t.dtype != torch.float32 for t in extra)):
        raise ValueError("lm_inertial_plan: float32 packed preintegrations "
                         "and weights, int32 edges, bool validity")
    E, R, dev = imu.edge.shape[0], red.vel.shape[0], imu.pre.device
    rows = {k: None if v is None else v.shape[0]
            for k, v in red._asdict().items()}
    want = (dict(pose=None, vel=R, bg=1, ba=1, gdir=1, scale=1) if gs
            else dict(pose=R, vel=R, bg=R, ba=R, gdir=None, scale=None))
    if rows != want:
        raise ValueError(f"lm_inertial_plan: rows {rows} do not make the "
                         "VI BA's or the initialisation's layout")
    i32 = dict(dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    plan = InertialPlan(torch.empty((E, 81), **f64),
                        torch.empty((R + 1,), **i32),
                        torch.empty((2 * E,), **i32),
                        torch.empty((E,), **i32), torch.empty((1,), **i32))
    ptr = cuda.ptr
    cuda.call("vsg_lm_inertial_plan", ptr(imu.pre), ptr(imu.edge),
              ptr(imu.valid), E, R, *map(ptr, plan[:5]), cuda.stream())
    lm_inertial_plan.launches += 1
    nd = 15 if gs else 24
    # the edge index the rows launch stages: edge, vedge, rptr, redge
    ix = 5 * E + R + 1
    jac = torch.empty((E * 9 * nd,), **f64)
    grd = torch.empty((E * (nd + 1),), **f64)
    offs = offsets(red)
    solve = _ImuSolve(
        ptr(imu.pre), ptr(imu.edge), ptr(imu.T_bc),
        ptr(imu.poses if gs else None), ptr(None if gs else imu.info_g),
        ptr(None if gs else imu.info_a), *map(ptr, plan[:5]), ptr(jac),
        ptr(grd), E, R, int(gs), offs["D"],
        ix if 4 * ix <= _IX_SHARED_BYTES else 0, float(imu.prior),
        (ctypes.c_int * 6)(*(offs.get(k, -1) for k in FAMILIES)))
    args = _InertialArgs(solve, ctypes.addressof(solve),
                         (ctypes.c_void_p * 6)(),
                         tuple(None if v is None else tuple(v.shape)
                               for v in red), (imu, jac, grd))
    return plan._replace(args=args)


lm_inertial_plan.launches = 0


def _inertial_values(name, plan: InertialPlan, red: Reduced) -> ctypes.Array:
    """The plan's value-pointer array, filled from ``red`` (checked
    against the plan's layout)."""
    if plan is None or plan.args is None:
        raise ValueError(f"{name}: CUDA tensors take the solve's "
                         "lm_inertial_plan(imu, red)")
    a = plan.args
    for i, (v, shape) in enumerate(zip(red, a.shapes)):
        if v is None and shape is None:
            a.vals[i] = None
            continue
        if (v is None or tuple(v.shape) != shape or not v.is_cuda
                or v.dtype != torch.float32 or not v.is_contiguous()):
            raise ValueError(f"{name}: the values do not match the plan's "
                             "layout (contiguous float32 CUDA tables)")
        a.vals[i] = v.data_ptr()
    return a.vals


def lm_inertial_assemble(imu: ImuRows, red: Reduced, H=None, g=None,
                         plan: InertialPlan | None = None):
    """K22b's assembly on CUDA tensors (adds into float64 ``H``, ``g``, or
    writes new ones when None; one launch, bitwise equal from launch to
    launch), the twin on CPU tensors; as ``lm_inertial_assemble_torch``.
    ``plan`` is the solve's ``lm_inertial_plan(imu, red)``, required on
    the card (the twin takes none)."""
    if imu.pre.device.type == "cpu":
        return lm_inertial_assemble_torch(imu, red, H, g)
    vals = _inertial_values("lm_inertial_assemble", plan, red)
    D = plan.args.solve.D
    zero = H is None
    if zero:
        H = torch.empty((D, D), dtype=torch.float64, device=imu.pre.device)
        g = torch.empty((D,), dtype=torch.float64, device=imu.pre.device)
    elif (not H.is_cuda or not g.is_cuda or H.dtype != torch.float64
          or g.dtype != torch.float64 or H.shape != (D, D)
          or g.shape != (D,)):
        raise ValueError("lm_inertial_assemble: float64 (D, D) H, (D,) g "
                         "on the card")
    cuda.call("vsg_lm_inertial_assemble", plan.args.addr, vals, cuda.ptr(H),
              cuda.ptr(g), int(zero), cuda.stream())
    lm_inertial_assemble.launches += 1
    return H, g


lm_inertial_assemble.launches = 0


def lm_inertial_cost(imu: ImuRows, red: Reduced, acc=None,
                     plan: InertialPlan | None = None):
    """K22b's cost entry on CUDA tensors (float64, added to ``acc`` when
    given; one launch), the twin on CPU tensors; as
    ``lm_inertial_cost_torch``.  ``plan`` as for
    ``lm_inertial_assemble``."""
    if imu.pre.device.type == "cpu":
        return lm_inertial_cost_torch(imu, red, acc)
    vals = _inertial_values("lm_inertial_cost", plan, red)
    cost = acc if acc is not None else torch.empty(
        (), dtype=torch.float64, device=imu.pre.device)
    if cost.dtype != torch.float64 or not cost.is_cuda:
        raise ValueError("lm_inertial_cost: a float64 cost on the card")
    cuda.call("vsg_lm_inertial_cost", plan.args.addr, vals, cuda.ptr(cost),
              int(acc is None), cuda.stream())
    lm_inertial_cost.launches += 1
    return cost


lm_inertial_cost.launches = 0


# ---------------------------------------------------------------------------
# K22c: the damped, gauge-masked dense solve and the retraction
# ---------------------------------------------------------------------------


def retract(red: Reduced, dx) -> Reduced:
    """Every family moved by its slice of ``dx``: SE(3) by the left
    ``boxplus``, velocities and biases by addition, the gravity direction
    by q so3_exp([d, 0]), the scale by s exp(d)."""
    from visual_sgraphs_tpu_torch.inertial import factors as ifac
    offs = offsets(red)
    out = {}
    for k in FAMILIES:
        v = getattr(red, k)
        if v is None:
            continue
        t = TANGENT[k]
        d = dx[offs[k]:offs[k] + v.shape[0] * t].reshape(v.shape[0], t)
        if k == "pose":
            out[k] = lie.se3_boxplus(v, d)
        elif k == "gdir":
            out[k] = ifac.gdir_retract(v, d)
        elif k == "scale":
            out[k] = ifac.scale_retract(v, d)
        else:
            out[k] = v + d
    return Reduced(**out)


def lm_solve_torch(H, g, pairs, rhs_pairs, free, lam, red: Reduced):
    """Plain twin of K22c: S = H + diag(lam clamp(diag H, 1e-6) + eps) -
    pairs (pose block), rhs = -g + rhs_pairs, the gauge mask (fixed
    columns become identity rows with zero rhs), a Cholesky solve whose
    non-finite or failed steps are zeroed, and the retraction.  Returns
    (dx (D,), candidate families)."""
    if H.is_cuda:
        lm_solve_torch.cuda_calls += 1
    dtype = H.dtype
    diag = torch.clamp(torch.diagonal(H), min=1e-6)
    S = H + torch.diag(lam.to(dtype) * diag + _eps(red_dtype(red)))
    rhs = -g
    if pairs is not None:
        P6 = pairs.shape[0]
        S = torch.cat([torch.cat([S[:P6, :P6] - pairs, S[:P6, P6:]], dim=1),
                       S[P6:]], dim=0)
        rhs = torch.cat([rhs[:P6] + rhs_pairs, rhs[P6:]])
    fm = free.to(dtype)
    S = S * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    rhs = rhs * fm
    Ls, info = torch.linalg.cholesky_ex(S)
    dx = torch.cholesky_solve(rhs[:, None], Ls)[:, 0]
    dx = torch.where(torch.isfinite(dx) & (info == 0), dx, 0.0) * fm
    dx = dx.to(red_dtype(red))
    return dx, retract(red, dx)


lm_solve_torch.cuda_calls = 0


def red_dtype(red: Reduced):
    return next(v for v in red if v is not None).dtype


# the stored width of each reduced family's rows
STORE = {"pose": 7, "vel": 3, "bg": 3, "ba": 3, "gdir": 4, "scale": 1}
# the shared memory one block may use on the H100: csrc/lm_solve.cu keeps
# its tiles there when they fit beside its vectors, else in global scratch
_SOLVE_SHARED_MAX = 232448


@functools.lru_cache(maxsize=None)
def _solve_layout(rows: tuple) -> tuple:
    """K22c's layout for the families' row counts (None where absent): the
    host array of the counts, D, the sizes of the flat output's parts (dx,
    then each present family's candidates), each family's candidate shape
    (None where absent), and the float64 scratch entries the tiles need
    past shared memory (0 when they fit)."""
    D = sum(TANGENT[k] * (n or 0) for k, n in zip(FAMILIES, rows))
    shapes = tuple(None if n is None else (n, STORE[k])
                   for k, n in zip(FAMILIES, rows))
    sizes = [D] + [a * b for a, b in filter(None, shapes)]
    nt = -(-D // 16)
    tiles = nt * (nt + 1) // 2 * 256
    shared = 8 * tiles + 20 * 16 * nt <= _SOLVE_SHARED_MAX
    return ((ctypes.c_int * 6)(*(n or 0 for n in rows)), D, sizes, shapes,
            0 if shared else tiles)


def lm_solve(H, g, pairs, rhs_pairs, free, lam, red: Reduced):
    """K22c on CUDA tensors (float64 H, g, pairs, rhs; the step in the
    values' float32), the twin on CPU tensors; as ``lm_solve_torch``.  The
    step and the candidates are views of one output buffer."""
    if H.device.type == "cpu":
        return lm_solve_torch(H, g, pairs, rhs_pairs, free, lam, red)
    vals = [v for v in red if v is not None]
    cuda.require_cuda("lm_solve", H, g, free, lam, *vals,
                      *(() if pairs is None else (pairs, rhs_pairs)))
    rows, D, sizes, shapes, n_scratch = _solve_layout(
        tuple(None if v is None else v.shape[0] for v in red))
    if (H.dtype != torch.float64 or H.shape != (D, D)
            or free.dtype != torch.bool or free.shape != (D,)
            or lam.dtype != torch.float32 or lam.numel() != 1
            or any(v.dtype != torch.float32 for v in vals)
            or (pairs is not None and pairs.dtype != torch.float64)):
        raise ValueError("lm_solve: float64 (D, D) system, (D,) bool mask, "
                         "float32 lambda and values")
    out = torch.empty((sum(sizes),), dtype=torch.float32, device=H.device)
    scratch = (torch.empty((n_scratch,), dtype=torch.float64,
                           device=H.device) if n_scratch else None)
    ptr = cuda.ptr
    cuda.call("vsg_lm_solve", ptr(H), ptr(g), ptr(pairs), ptr(rhs_pairs),
              0 if pairs is None else pairs.shape[0], ptr(free), D, ptr(lam),
              _eps(torch.float32), ptr(out), *map(ptr, red), rows,
              ptr(scratch), cuda.stream())
    lm_solve.launches += 1
    dx, *parts = out.split(sizes)
    parts = iter(parts)
    return dx, Reduced(*(None if sh is None else next(parts).view(sh)
                         for sh in shapes))


lm_solve.launches = 0


# ---------------------------------------------------------------------------
# the LM loop
# ---------------------------------------------------------------------------


def optimize_reproj_inertial(red: Reduced, free, iters: int, pts=None,
                             pt_fixed=None, rows: ReprojRows | None = None,
                             cam=None, bf=None,
                             imu: ImuRows | None = None) -> LmResult:
    """``iters`` LM iterations of the engine's schedule (``solve.lm_loop``)
    over the reduced families ``red`` (gauge mask ``free``), the points
    ``pts`` eliminated through the reprojection ``rows`` and the inertial
    factors ``imu``: each step is K22a's reduction, K22b's assembly, K22c's
    solve and retraction, K22a's back-substitution and cost and K22b's cost
    (twins on CPU tensors); nothing is read back."""
    dtype = red_dtype(red)
    D = offsets(red)["D"]
    if bf is None and rows is not None:
        bf = torch.zeros((), dtype=dtype, device=free.device)
    # the rows do not change across the solve: grouped once, and the
    # inertial edges whitened and indexed once
    plan = None if rows is None else lm_reproj_plan(rows, pts.shape[0])
    iplan = None if imu is None else lm_inertial_plan(imu, red)

    def cost_at(r: Reduced, p, state=None, dx=None):
        acc = None
        if rows is not None:
            p, acc = lm_reproj_cost(r.pose, p, pt_fixed, rows, cam, bf,
                                    state, dx, plan=plan)
        if imu is not None:
            acc = lm_inertial_cost(imu, r, acc, iplan)
        return p, acc

    def as_dict(r: Reduced, p) -> dict:
        out = {k: v for k, v in r._asdict().items() if v is not None}
        if p is not None:
            out["pts"] = p
        return out

    def step(values, lam):
        r = Reduced(**{k: v for k, v in values.items() if k != "pts"})
        p = values.get("pts")
        H = g = pairs = rhs_p = state = None
        if rows is not None:
            H, g, pairs, rhs_p, state = lm_reproj_reduce(
                r.pose, p, rows, cam, bf, lam, D, plan)
        if imu is not None:
            H, g = lm_inertial_assemble(imu, r, H, g, iplan)
        dx, cand = lm_solve(H, g, pairs, rhs_p, free, lam, r)
        cand_pts, cand_cost = cost_at(cand, p, state, dx)
        return as_dict(cand, cand_pts), cand_cost

    res = lm_loop(as_dict(red, pts), cost_at(red, pts)[1], iters, step,
                  lam_dtype=dtype)
    out = dict(res.values)
    return LmResult(red=Reduced(**{k: v for k, v in out.items()
                                   if k != "pts"}),
                    pts=out.get("pts"), cost=res.cost.to(dtype),
                    initial_cost=res.initial_cost.to(dtype), lam=res.lam,
                    accepted=res.accepted)
