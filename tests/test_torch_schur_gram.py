"""K8's function and K22a's row plan on the CPU.

The landmark Schur reduction's twin (``local_reduced_system_torch``) and
back-substitution (``back_substitute_torch``) against the reference's
``_local_reduced_system`` / ``_back_substitute`` (jitted), on seeded
problems with two observations of one landmark at one slot, empty rows and
more observations than slots; the slot-collapsed Gram form the kernel sums
(``schur_gram``) against the pair-by-pair twin on the same problems;
and K22a's per-landmark row index (``lm_reproj_plan_torch``) against a
numpy grouping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.parallel import dist_ba as rdist
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
from visual_sgraphs_tpu_torch.parallel import dist_ba as pdist

from torch_parity import one_torch_thread  # noqa: F401

CAM = np.array([260.0, 260.0, 159.5, 119.5])
BF = 20.8
LAM, HUBER = 1e-4, 2.45
# float64 on both sides: the packages differ only in summation order
# (one-hot contractions against index_add_), ~1e-15 of the largest entry
F64_TOL = 1e-9
# but the reference's pair-block contraction returns float32
# (preferred_element_type): its S is ~1e-7 of its largest entry off
REF_S_TOL = 1e-5
# the Gram form in float32 against the float64 twin: the kernel's own
# tolerance (selfcheck.SCHUR_TOL), relative to each output's largest entry
F32_TOL = 1e-3

# (n, O, L, duplicate-slot share, empty-row share)
CASES = {
    "L4_O6_more_obs_than_slots": (64, 6, 4, 0.0, 0.2),
    "L11_O12_duplicates_empty": (256, 12, 11, 0.15, 0.3),
    "L11_O6_distinct": (128, 6, 11, 0.0, 0.0),
}


def schur_problem(n, O, L, dup, empty, seed=0):
    """Seeded float64 numpy operands of K8: L poses T_cw near the identity,
    n points 2-7 m ahead, each row with 1..O observations at random slots
    (drawn with replacement when O > L, so slots repeat), a ``dup`` share
    of rows repeating one slot twice, an ``empty`` share with none, noisy
    pixels, 80 % stereo, 5 % invalid."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=(L, 3)) * 0.05
    th = np.linalg.norm(ang, axis=1, keepdims=True)
    q = np.concatenate([np.cos(th / 2), np.sin(th / 2) * ang / th], axis=1)
    pose = np.concatenate([q, rng.normal(size=(L, 3)) * 0.2], axis=1)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2.0, 7.0, n)], -1)
    kf = np.full((n, O), -1, np.int64)
    for i in range(n):
        if rng.uniform() < empty:
            continue
        m = int(rng.integers(1, O + 1))
        kf[i, :m] = rng.choice(L, m, replace=m > L)
        if m >= 2 and rng.uniform() < dup:
            kf[i, m - 1] = kf[i, 0]
    qw, qx, qy, qz = (pose[np.maximum(kf, 0), k] for k in range(4))
    R = np.stack([
        np.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                  2 * (qx * qz + qw * qy)], -1),
        np.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                  2 * (qy * qz - qw * qx)], -1),
        np.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                  1 - 2 * (qx * qx + qy * qy)], -1)], -2)
    p = np.einsum("noij,nj->noi", R, X) + pose[np.maximum(kf, 0), 4:7]
    z = np.maximum(p[..., 2], 1e-3)
    u = CAM[0] * p[..., 0] / z + CAM[2] + rng.normal(size=z.shape)
    v = CAM[1] * p[..., 1] / z + CAM[3] + rng.normal(size=z.shape)
    ur = np.where(rng.uniform(size=z.shape) < 0.8, u - BF / z, -1.0)
    uvr = np.stack([u, v, ur], -1)
    val = (kf >= 0) & (rng.uniform(size=kf.shape) > 0.05)
    X0 = X + rng.normal(size=X.shape) * 0.02
    return dict(pose=pose, pts=X0, kf_tab=kf.astype(np.int32), uvr=uvr,
                val=val)


def port_args(p, dtype=torch.float64):
    f = lambda x: torch.from_numpy(np.asarray(x)).to(dtype)  # noqa: E731
    return (f(p["pose"]), f(p["pts"]), torch.from_numpy(p["kf_tab"]),
            f(p["uvr"]), torch.from_numpy(p["val"]), f(CAM),
            torch.tensor(BF, dtype=dtype))


@pytest.fixture(scope="module")
def reference():
    reduce = jax.jit(rdist._local_reduced_system)
    back = jax.jit(rdist._back_substitute)
    out = {}
    for name, spec in CASES.items():
        p = schur_problem(*spec)
        ref = reduce(jnp.asarray(p["pose"]), jnp.asarray(p["pts"]),
                     jnp.asarray(p["kf_tab"]), jnp.asarray(p["uvr"]),
                     jnp.asarray(p["val"]), jnp.asarray(CAM),
                     jnp.asarray(BF), LAM, HUBER)
        L = p["pose"].shape[0]
        dx6 = np.random.default_rng(1).normal(size=(L, 6)) * 1e-3
        dxe = back(*ref[2:5], jnp.asarray(p["kf_tab"]),
                   jnp.asarray(p["val"]), jnp.asarray(dx6))
        out[name] = (p, [np.asarray(r) for r in ref], dx6, np.asarray(dxe))
    return out


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reduced_system_matches_reference(reference, case):
    p, ref, _, _ = reference[case]
    n, O, L = p["kf_tab"].shape + (p["pose"].shape[0],)
    if case.startswith("L4"):
        assert O > L
    if "duplicates" in case:
        rows = [np.unique(r[r >= 0]).size < (r >= 0).sum()
                for r in p["kf_tab"]]
        assert any(rows)
    if "empty" in case:
        assert (~p["val"].any(axis=1)).any()
    out = pdist.local_reduced_system_torch(*port_args(p), lam=LAM,
                                           huber=HUBER)
    for name, a, b in zip(("S", "rhs", "Hinv", "bx", "W", "cost"), out, ref):
        assert a.shape == b.shape, name
        assert rel(a.numpy(), b) <= (REF_S_TOL if name == "S" else F64_TOL), \
            name


@pytest.mark.parametrize("case", sorted(CASES))
def test_back_substitute_matches_reference(reference, case):
    p, ref, dx6, dxe = reference[case]
    out = pdist.back_substitute_torch(
        *(torch.from_numpy(r) for r in ref[2:5]),
        torch.from_numpy(p["kf_tab"]), torch.from_numpy(p["val"]),
        torch.from_numpy(dx6))
    assert rel(out.numpy(), dxe) <= F64_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_gram_form_matches_pair_twin(reference, case):
    p = reference[case][0]
    S, rhs = pdist.local_reduced_system_torch(*port_args(p), lam=LAM,
                                              huber=HUBER)[:2]
    gS, grhs = schur_gram(*port_args(p), lam=LAM, huber=HUBER)
    assert rel(gS.numpy(), S.numpy()) <= F64_TOL
    assert rel(grhs.numpy(), rhs.numpy()) <= F64_TOL
    fS, frhs = schur_gram(*port_args(p, torch.float32), lam=LAM,
                          huber=HUBER)
    assert rel(fS.numpy(), S.numpy()) <= F32_TOL
    assert rel(frhs.numpy(), rhs.numpy()) <= F32_TOL


def schur_gram(kf_pose, pts, kf_tab, uvr_tab, val_tab, cam_K, bf, lam,
               huber):
    """The arithmetic K8's kernel sums, in plain torch: the observations of
    each landmark at one slot summed into P_s (3, 6) = sum W^T, B_s = Lc^-1
    P_s with Hxx + damping = Lc Lc^T, and S = blockdiag(sum Hpp) - sum_n
    B_n^T B_n over the landmark blocks B_n (3, 6K), rhs = sum (P_s Hxx^-1
    bx - gp_s).  Returns (S, rhs)."""
    K = kf_pose.shape[0]
    n, O = kf_tab.shape
    r, Jp, Jx, w, _ = pdist._landmark_terms(kf_pose, pts, kf_tab, uvr_tab,
                                            val_tab, cam_K, bf, huber)
    slot_ok = val_tab & (kf_tab >= 0)
    okf = slot_ok.to(r.dtype)
    row = (torch.arange(n, device=r.device)[:, None] * K
           + torch.clamp(kf_tab, min=0).long()).reshape(-1)
    W = torch.einsum("nori,norj,no->noij", Jp, Jx, w) * okf[..., None, None]
    P = torch.zeros((n * K, 6, 3), dtype=r.dtype, device=r.device)
    P.index_add_(0, row, W.reshape(-1, 6, 3))
    Hpp = torch.einsum("nori,norj,no->noij", Jp, Jp, w) * okf[..., None, None]
    gp = torch.einsum("nori,nor,no->noi", Jp, r, w) * okf[..., None]
    Hxx = torch.einsum("nori,norj,no->nij", Jx, Jx, w)
    bx = torch.einsum("nori,nor,no->ni", Jx, r, w)
    dx = torch.clamp(torch.diagonal(Hxx, dim1=-2, dim2=-1), min=1e-6)
    Hxx = Hxx + torch.diag_embed(lam * dx + 1e-5)
    Lc = torch.linalg.cholesky(Hxx)
    Pt = P.reshape(n, K, 6, 3).permute(0, 3, 1, 2).reshape(n, 3, 6 * K)
    B = torch.linalg.solve_triangular(Lc, Pt, upper=False)
    S1 = torch.zeros((K, 6, 6), dtype=r.dtype, device=r.device)
    S1.index_add_(0, torch.clamp(kf_tab, min=0).long().reshape(-1),
                  Hpp.reshape(-1, 6, 6))
    S = -torch.einsum("nkd,nke->de", B, B).reshape(K, 6, K, 6)
    kk = torch.arange(K, device=r.device)
    S[kk, :, kk, :] += S1
    hb = torch.linalg.solve(Hxx, bx[..., None])[..., 0]
    rhs = torch.einsum("nkd,nk->d", Pt, hb)
    gsum = torch.zeros((K, 6), dtype=r.dtype, device=r.device).index_add_(
        0, torch.clamp(kf_tab, min=0).long().reshape(-1), gp.reshape(-1, 6))
    rhs = rhs - gsum.reshape(-1)
    return S.reshape(6 * K, 6 * K), rhs


def numpy_plan(pt, use, N):
    """Each landmark's used rows in row order, by plain loops."""
    ptr, idx = [0], []
    for n in range(N):
        idx += [m for m in range(len(pt)) if use[m] and pt[m] == n]
        ptr.append(len(idx))
    return np.array(ptr), np.array(idx + [-1] * (len(pt) - len(idx)))


@pytest.mark.parametrize("M, N, seed", [(0, 5, 0), (40, 1, 1), (500, 64, 2),
                                        (3000, 400, 3)])
def test_lm_plan_matches_numpy(M, N, seed):
    rng = np.random.default_rng(seed)
    # slot-major rows as the windows make them; ids past the landmarks
    # (never used on the main path) and unused rows pointing anywhere
    pt = rng.integers(0, N + 3, M).astype(np.int32)
    use = (rng.uniform(size=M) < 0.7) & (pt < N + 1)
    rows = lmk.ReprojRows(
        slot=torch.from_numpy(np.arange(M, dtype=np.int32) // 50),
        pt=torch.from_numpy(pt), uvr=torch.zeros((M, 3)),
        use=torch.from_numpy(use), stereo=torch.zeros(M, dtype=torch.bool))
    plan = lmk.lm_reproj_plan(rows, N)
    ptr, idx = numpy_plan(pt, use, N)
    assert plan.ptr.dtype == torch.int32 and plan.idx.dtype == torch.int32
    assert np.array_equal(plan.ptr.numpy(), ptr)
    assert np.array_equal(plan.idx.numpy(), idx)
    if N > 1:
        assert (np.diff(ptr) == 0).any()  # landmarks with no rows
