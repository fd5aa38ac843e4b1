"""K26's twin on the CPU: the Schur BAs' damped solve and retraction.

``dist_ba.ba_solve_torch`` (``solve_damped`` and the retraction of poses,
planes, rooms and doors) against the reference's arithmetic, jitted: the
damping, the gauge mask, ``cho_factor`` / ``cho_solve``, the non-finite
zeroing and the ``vmap`` retraction of
``visual_sgraphs_tpu/optim/fast_ba.py:389-421`` (``fast_local_ba``'s
:163-178 and the global BA's ``parallel/dist_ba.py:289-301`` are the same
with keyframes alone), on the seeded systems of
``selfcheck.ba_solve_inputs``: the windowed local BA's D = 66, the
scene-graph BA's D = 402 (fixed keyframes, planes, rooms and doors) and
the global BA's D = 768 and 1536 (128 and 256 keyframes), in float64 and
in float32, and a scene-graph system that is not positive definite (a
zero step on both sides).  Also K8's back-substitution with the points'
update folded in, against the reference's ``_back_substitute`` and point
update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.core import plane as rplane
from visual_sgraphs_tpu.parallel import dist_ba as rdist
from visual_sgraphs_tpu_torch import selfcheck
from visual_sgraphs_tpu_torch.parallel import dist_ba

from torch_parity import one_torch_thread  # noqa: F401

# float64 on both sides: two Cholesky factorisations of one system
F64_TOL = 1e-9
# float32 on both sides (LAPACK's blocking against XLA's): the step
# relative to its largest entry, and the moved values per component
F32_STEP_TOL = 1e-5
F32_VALUE_TOL = 1e-5


def _ref_solve(S, rhs, free, lam, poses, planes, rooms, doors):
    """fast_ba.py:391-421 of the reference, the fixed flags read off the
    gauge mask's rows."""
    counts = [0 if v is None else v.shape[0]
              for v in (poses, planes, rooms, doors)]
    lam_a = jnp.asarray(lam, S.dtype)
    diag = jnp.clip(jnp.diagonal(S), 1e-6, None)
    S = S + jnp.diag(lam_a * diag + 1e-5)
    S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    rhs = rhs * free
    cf = jax.scipy.linalg.cho_factor(S, lower=True)
    dx = jax.scipy.linalg.cho_solve(cf, rhs)
    dx = jnp.where(jnp.isfinite(dx), dx, 0.0) * free
    out, off = [dx], 0
    for vals, t, n in zip((poses, planes, rooms, doors), (6, 3, 3, 6),
                          counts):
        if vals is None:
            out.append(None)
            continue
        fixed = free[off:off + t * n:t] == 0
        d = jnp.where(fixed[:, None], 0.0, dx[off:off + t * n].reshape(n, t))
        if t == 6:
            out.append(jax.vmap(lambda T, d: rlie.se3_normalize(
                rlie.se3_boxplus(T, d)))(vals, d))
        elif vals is planes:
            out.append(jax.vmap(rplane.oplus)(vals, d))
        else:
            out.append(vals + d)
        off += t * n
    return out


_ref_jit = jax.jit(_ref_solve)


def _compare(ops, dtype, step_tol, value_tol):
    S, rhs, free, lam, *values = ops
    cast = [None if v is None else v.to(dtype) for v in values]
    got = dist_ba.ba_solve_torch(S.to(dtype), rhs.to(dtype), free.to(dtype),
                                 lam, *cast)
    want = _ref_jit(*(None if t is None else t.numpy()
                      for t in (S.to(dtype), rhs.to(dtype), free.to(dtype))),
                    lam, *(None if v is None else v.numpy() for v in cast))
    dx, ref_dx = got[0].numpy(), np.asarray(want[0])
    scale = max(float(np.abs(ref_dx).max()), 1e-30)
    assert float(np.abs(dx - ref_dx).max()) <= step_tol * scale
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=value_tol)
    return got, want


@pytest.mark.parametrize("layout", list(selfcheck.BA_LAYOUTS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ba_solve_twin_matches_reference(layout, dtype):
    ops = selfcheck.ba_solve_inputs("cpu", layout)
    free = ops[2]
    assert 0 < int(free.sum()) < free.numel()
    if dtype == "float64":
        _compare(ops, torch.float64, F64_TOL, F64_TOL)
    else:
        _compare(ops, torch.float32, F32_STEP_TOL, F32_VALUE_TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ba_solve_not_positive_definite_gives_zero_step(dtype):
    ops = selfcheck.ba_solve_inputs("cpu", "sg", pd=False)
    got, want = _compare(ops, dtype, 0.0, F32_VALUE_TOL)
    assert (got[0] == 0).all() and (np.asarray(want[0]) == 0).all()
    # a zero step: rooms unchanged, poses renormalised in place
    np.testing.assert_array_equal(got[3].numpy(), ops[6].to(dtype).numpy())
    np.testing.assert_allclose(got[1].numpy(), ops[4].to(dtype).numpy(),
                               rtol=0, atol=1e-6)


def test_back_substitute_points_match_reference():
    # the moved points of K8's back-substitution entry (the twin here)
    # against the reference's _back_substitute and point update
    # (fast_ba.py:176-177, dist_ba.py:303-304), jitted, in float64
    rng = np.random.default_rng(2)
    n, O, L = 64, 6, 11
    Hinv = rng.normal(size=(n, 3, 3))
    bx = rng.normal(size=(n, 3))
    W = rng.normal(size=(n, O, 6, 3))
    kf_tab = np.where(rng.uniform(size=(n, O)) < 0.2, -1,
                      rng.integers(0, L, (n, O))).astype(np.int32)
    val = rng.uniform(size=(n, O)) < 0.9
    dx6 = rng.normal(size=(L, 6)) * 1e-3
    pts = rng.normal(size=(n, 3)) * 3.0
    pt_ok = rng.uniform(size=n) < 0.8
    ops = (Hinv, bx, W, kf_tab, val, dx6, pts, pt_ok)

    @jax.jit
    def ref(Hinv, bx, W, kf_tab, val, dx6, pts, pt_ok):
        dxe = rdist._back_substitute(Hinv, bx, W, kf_tab, val, dx6)
        return pts + jnp.where(pt_ok[:, None], dxe, 0.0)

    want = np.asarray(ref(*(jnp.asarray(x) for x in ops)))
    got = dist_ba.back_substitute(*(torch.from_numpy(x) for x in ops))
    got = got.numpy()
    assert not pt_ok.all() and pt_ok.any()
    np.testing.assert_array_equal(got[~pt_ok], pts[~pt_ok])
    step = np.abs(want - pts).max()
    assert np.abs(got - want).max() <= F64_TOL * step
