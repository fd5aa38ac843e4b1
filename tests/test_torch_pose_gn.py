"""K6 (pose-only Gauss-Newton): its cluster plan against the card's
limits, and the kernel's transposed warp reduction and 6x6 solve applied
by plain loops against direct sums and a dense solve.
"""

import numpy as np
import pytest

from visual_sgraphs_tpu_torch.slam import tracking

from torch_parity import one_torch_thread  # noqa: F401

PORTABLE_CLUSTER = 8  # CTAs a cluster without the non-portable attribute
H100_SMEM = 232448  # shared-memory bytes a CTA may use on the H100
STATIC_SMEM = 8 * 32 * 4 + 2 * 8 * 32 * 4  # the kernel's red and inbox


@pytest.mark.parametrize("M", [0, 1, 31, 257, 512, 513, 1000, 4096, 8192,
                               60000])
def test_pose_gn_plan_limits(M):
    p = tracking.pose_gn_plan(M)
    assert 1 <= p.cluster <= PORTABLE_CLUSTER
    assert p.cluster * p.chunk >= M and (p.cluster - 1) * p.chunk < max(M, 1)
    assert p.smem >= tracking.POSE_GN_BYTES * p.chunk and p.smem % 16 == 0
    assert p.smem + STATIC_SMEM <= H100_SMEM
    assert tracking.POSE_GN_STATIC >= STATIC_SMEM
    # a few hundred matches take one CTA; 4096 a cluster of 8
    if M <= 512:
        assert p.cluster == 1
    if M >= 4096:
        assert p.cluster == PORTABLE_CLUSTER


def test_pose_gn_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        tracking.pose_gn_plan(10**6)


def transpose_sum(v):
    """csrc/pose_gn.cu::transpose_sum over a warp: v (32 lanes, 32 values)
    -> (32,) with lane k holding the sum of v[:, k]."""
    v = v.copy()
    lanes = np.arange(32)
    h = 16
    while h >= 1:
        up = (lanes & h) != 0
        nv = v.copy()
        for i in range(h):
            send = np.where(up, v[:, i], v[:, i + h])
            keep = np.where(up, v[:, i + h], v[:, i])
            nv[:, i] = keep + send[lanes ^ h]
        v = nv
        h >>= 1
    return v[:, 0]


def test_transpose_sum_leaves_sum_k_on_lane_k():
    rng = np.random.default_rng(0)
    v = rng.integers(-1000, 1000, (32, 32)).astype(np.float64)
    np.testing.assert_array_equal(transpose_sum(v), v.sum(axis=0))


def solve6(tot):
    """csrc/pose_gn.cu::solve6: tot (27,) sums (H's upper entries row by
    row, then g) -> dx solving (H + 1e-3 I) dx = -g by a Cholesky with
    reciprocal-square-root pivots; non-finite entries zeroed."""
    tot = np.asarray(tot, np.float64)
    A = np.zeros((6, 6))
    n = 0
    for i in range(6):
        for j in range(i, 6):
            A[i, j] = A[j, i] = tot[n]
            n += 1
    A += 1e-3 * np.eye(6)
    g = tot[21:27]
    L = np.zeros((6, 6))
    dinv = np.zeros(6)
    y = np.zeros(6)
    dx = np.zeros(6)
    with np.errstate(all="ignore"):
        for j in range(6):
            d = A[j, j] - sum(L[j, p] ** 2 for p in range(j))
            dinv[j] = 1.0 / np.sqrt(d)
            L[j, j] = d * dinv[j]
            for i in range(j + 1, 6):
                t = A[i, j] - sum(L[i, p] * L[j, p] for p in range(j))
                L[i, j] = t * dinv[j]
        for i in range(6):
            y[i] = (-g[i] - sum(L[i, p] * y[p] for p in range(i))) * dinv[i]
        for r in range(5, -1, -1):
            s = y[r] - sum(L[p, r] * dx[p] for p in range(r + 1, 6))
            dx[r] = s * dinv[r]
    return np.where(np.isfinite(dx), dx, 0.0)


def _tot(H, g):
    return np.concatenate([H[np.triu_indices(6)], g])


@pytest.mark.parametrize("prior", [0.0, 10.0, 1e9])
def test_solve6_matches_dense_solve(prior):
    # normal equations of 40 random rows, with K6's prior added as the
    # kernel adds it (w on H's diagonal)
    rng = np.random.default_rng(1)
    J = rng.normal(size=(40, 6)) * [60, 60, 20, 300, 300, 100]
    H = J.T @ J + prior * np.eye(6)
    g = J.T @ rng.normal(size=40)
    want = np.linalg.solve(H + 1e-3 * np.eye(6), -g)
    np.testing.assert_allclose(solve6(_tot(H, g)), want, rtol=1e-9,
                               atol=1e-15)


def test_solve6_zeroes_a_step_that_is_not_finite():
    H = -np.eye(6)
    assert (solve6(_tot(H, np.ones(6))) == 0.0).all()
