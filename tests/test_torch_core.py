"""Port parity: Lie groups, pinhole camera and ATE against the reference.

Inputs are seeded numpy float32 arrays fed to both packages.  Tolerance
1e-5: both sides compute in float32 with the same formulas; only the
evaluation order of a few sums and the libm of sin/cos/atan2 differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import cameras as rcam
from visual_sgraphs_tpu.core import geometry as rgeo
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu_torch.core import cameras as pcam
from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.core import lie as plie

TOL = 1e-5

from torch_parity import one_torch_thread  # noqa: F401


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _poses(rng, n):
    xi = _f32(rng, n, 6, scale=0.5)
    return np.asarray(rlie.se3_exp(jnp.asarray(xi)), np.float32)


def _close(ref, port, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp"])
def test_exp(fn, rng):
    xi = _f32(rng, 64, 6 if fn == "se3_exp" else 3, scale=0.7)
    xi[:4] *= 1e-5  # small-angle branch
    _close(getattr(rlie, fn)(jnp.asarray(xi)),
           getattr(plie, fn)(torch.from_numpy(xi)))


@pytest.mark.parametrize("fn", ["se3_log", "se3_inverse", "se3_normalize",
                                "quat_to_matrix"])
def test_unary_pose_ops(fn, rng):
    T = _poses(rng, 64)
    if fn == "quat_to_matrix":
        T = T[:, :4]
    _close(getattr(rlie, fn)(jnp.asarray(T)),
           getattr(plie, fn)(torch.from_numpy(T)))


@pytest.mark.parametrize("fn", ["se3_multiply", "se3_boxplus", "se3_apply"])
def test_binary_pose_ops(fn, rng):
    A = _poses(rng, 64)
    B = {"se3_multiply": _poses(rng, 64),
         "se3_boxplus": _f32(rng, 64, 6, scale=0.3),
         "se3_apply": _f32(rng, 64, 3, scale=2.0)}[fn]
    _close(getattr(rlie, fn)(jnp.asarray(A), jnp.asarray(B)),
           getattr(plie, fn)(torch.from_numpy(A), torch.from_numpy(B)))


def test_hat_and_identity(rng):
    v = _f32(rng, 16, 3)
    _close(rlie.hat(jnp.asarray(v)), plie.hat(torch.from_numpy(v)))
    _close(rlie.se3_identity(), plie.se3_identity())


def test_pinhole_project_unproject(rng):
    K = np.array([260.0, 261.0, 159.5, 119.5], np.float32)
    p = _f32(rng, 128, 3) + np.array([0, 0, 4.0], np.float32)
    _close(rcam.project_pinhole(jnp.asarray(K), jnp.asarray(p)),
           pcam.project_pinhole(torch.from_numpy(K), torch.from_numpy(p)),
           tol=1e-4)  # pixels ~ 1e2: relative 1e-5 of the value
    uv = _f32(rng, 128, 2, scale=100.0)
    d = np.abs(_f32(rng, 128)) + 0.5
    _close(rcam.unproject_pinhole(jnp.asarray(K), jnp.asarray(uv),
                                  jnp.asarray(d)),
           pcam.unproject_pinhole(torch.from_numpy(K), torch.from_numpy(uv),
                                  torch.from_numpy(d)))


def test_ate_rmse(rng):
    gt = _f32(rng, 50, 3)
    T = _poses(rng, 1)[0]
    est = np.asarray(rlie.se3_apply(jnp.asarray(T), jnp.asarray(gt)),
                     np.float32) + _f32(rng, 50, 3, scale=0.01)
    r_ate, r_S = rgeo.ate_rmse(jnp.asarray(est), jnp.asarray(gt))
    p_ate, p_S = pgeo.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt))
    _close(r_ate, p_ate)
    _close(r_S, p_S)
