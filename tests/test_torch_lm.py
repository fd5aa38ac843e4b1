"""The LM engine's kernel route (``optim/lm_kernels.py``): the plain twins
of K22a (reprojection rows and landmark Schur reduction), K22b (inertial
rows) and K22c (the damped, gauge-masked dense solve) against the
reference's generic engine (``optim/solve.py::_assemble`` /
``_solve_step``), and the whole route against the port's generic engine
on the VI local BA's inputs.  Inputs are made with numpy from a seed; the
CUDA kernels themselves are held against these twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.inertial import factors as rfac
from visual_sgraphs_tpu.inertial import init as rinit
from visual_sgraphs_tpu.inertial import preintegration as rpre
from visual_sgraphs_tpu.optim import factors as rfactors
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.optim import solve as rsolve
from visual_sgraphs_tpu_torch import interop, selfcheck
from visual_sgraphs_tpu_torch.inertial import preintegration as ppre
from visual_sgraphs_tpu_torch.inertial import vi_ba as pvba
from visual_sgraphs_tpu_torch.optim import graph as pgraph
from visual_sgraphs_tpu_torch.optim import lm_kernels as lmk
from visual_sgraphs_tpu_torch.optim import solve as psolve
from visual_sgraphs_tpu_torch.slam import mapping as pmap

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

CAM = np.float32([260.0, 260.0, 160.0, 120.0])
BF = np.float32(20.8)
L_SLOTS, N_PTS, F_KP = 4, 64, 48
WALK_G, WALK_A = 1.9e-5, 3.0e-3


def _poses(rng, n, scale):
    xi = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    return np.asarray(jax.vmap(rlie.se3_exp)(jnp.asarray(xi)), np.float32)


def reproj_case(seed: int = 0):
    """A 4-slot, 64-point window: 48 keypoints a slot, about half with
    depth (stereo rows), 0.5 px noise and a few 20 px outliers (Huber), a
    duplicate observation (slot 0 keypoints 0 and 47 on one point), a
    stereo row of a point behind the camera (past both depth floors, z <
    0), two padding points with no row (fixed), slot 0 fixed."""
    rng = np.random.default_rng(seed)
    poses = _poses(rng, L_SLOTS, 0.05)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (N_PTS, 2)),
                          rng.uniform(3.0, 6.0, (N_PTS, 1))],
                         axis=1).astype(np.float32)
    pts[N_PTS - 3] = [0.2, -0.1, -1.0]  # behind every camera
    slot, pt, uv, depth = [], [], [], []
    for s in range(L_SLOTS):
        ids = rng.choice(N_PTS - 3, F_KP, replace=False)
        if s == 0:
            ids[-1] = ids[0]  # a duplicate observation
        if s == 1:
            ids[-1] = N_PTS - 3  # the point behind the camera
        X = pts[ids] + rng.normal(size=(F_KP, 3)) * 0.01
        p = np.asarray(rlie.se3_apply(jnp.asarray(poses[s])[None],
                                      jnp.asarray(X)))
        noise = np.where(rng.uniform(size=F_KP) < 0.05, 20.0, 0.5)
        uv.append(np.stack([CAM[0] * p[:, 0] / p[:, 2] + CAM[2],
                            CAM[1] * p[:, 1] / p[:, 2] + CAM[3]], 1)
                  + rng.normal(size=(F_KP, 2)) * noise[:, None])
        stereo = (rng.uniform(size=F_KP) < 0.5) | (ids == N_PTS - 3)
        depth.append(np.where(stereo, np.abs(p[:, 2]) + 0.02, 0.0))
        slot.append(np.full(F_KP, s))
        pt.append(ids)
    uv = np.concatenate(uv).astype(np.float32)
    depth = np.concatenate(depth).astype(np.float32)
    ur = uv[:, 0] - BF / np.maximum(depth, 1e-3)
    uvr = np.concatenate([uv, ur[:, None]], 1).astype(np.float32)
    pt_fixed = np.zeros(N_PTS, bool)
    pt_fixed[N_PTS - 2:] = True
    kf_fixed = np.arange(L_SLOTS) == 0
    return dict(poses=poses, pts=pts, slot=np.int32(np.concatenate(slot)),
                pt=np.int32(np.concatenate(pt)), uvr=uvr, stereo=depth > 0,
                use=np.ones(L_SLOTS * F_KP, bool), pt_fixed=pt_fixed,
                kf_fixed=kf_fixed)


def _ref_reproj_batches(c, dtype):
    m = c["slot"].shape[0]
    var_idx = jnp.asarray(np.stack([c["slot"], c["pt"]], 1))
    cam = jnp.asarray(np.broadcast_to(CAM, (m, 4)), dtype)
    ones = jnp.ones((m,), dtype)
    use, st = c["use"], c["stereo"]
    return [
        rgraph.FactorBatch(
            ("kf", "pt"), rfactors.reproj_mono, 2, var_idx,
            {"uv": jnp.asarray(c["uvr"][:, :2], dtype), "cam": cam}, ones,
            jnp.asarray(use & ~st), huber=float(np.sqrt(5.991))),
        rgraph.FactorBatch(
            ("kf", "pt"), rfactors.reproj_stereo, 3, var_idx,
            {"uv_ur": jnp.asarray(c["uvr"], dtype), "cam": cam,
             "bf": jnp.full((m,), BF, dtype)}, ones, jnp.asarray(use & st),
            huber=float(np.sqrt(7.815)))]


def _port_rows(c):
    return lmk.ReprojRows(tp.t(c["slot"]), tp.t(c["pt"]), tp.t(c["uvr"]),
                          tp.t(c["use"]), tp.t(c["stereo"]))


def _jit(fn):
    """``fn()`` compiled once by XLA, its operands closed over (the
    reference's solver functions run eagerly are ~10x slower)."""
    return jax.jit(fn)()


def _jax_dtype(name):
    return jnp.float32 if name == "float32" else jnp.float64


def _scaled_err(a, b, d):
    """max |a - b| / sqrt(d_i d_j) (matrices), or over the largest
    |b| / sqrt(d_i) (vectors)."""
    s = np.sqrt(np.maximum(np.abs(d), 1e-30))
    if a.ndim == 2:
        return float((np.abs(a - b) / np.outer(s, s)).max())
    return float((np.abs(a - b) / s).max() / (np.abs(b) / s).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_reproj_reduce_twin(dtype):
    # K22a's twin: the reduced pose block S = H + diag(lam clamp(diag H,
    # 1e-6) + eps) - sum B^T B and rhs = -g + sum B^T c against the same
    # quantities formed in numpy from the reference's _assemble (H, g, Hxx,
    # bx, P) with _solve_step's damping; each entry scaled by sqrt(S_ii
    # S_jj): 1e-4 in float32 (the reference's forward-mode Jacobians
    # against analytic ones, sums in another order); 1e-6 in float64 (the
    # float32 poses' quaternions are unit only to ~1e-7, and forward-mode
    # AD through quat_rotate differentiates the non-unit quaternion where
    # the analytic [I | -hat(p)] assumes a rotation: 1.1e-7 measured)
    c = reproj_case()
    lam = 1e-3
    eps = 1e-8 if dtype == "float64" else 1e-5
    jd = _jax_dtype(dtype)
    with jax.enable_x64(dtype == "float64"):
        problem = rgraph.GraphProblem(
            families={"kf": rgraph.se3_family(jnp.asarray(c["poses"], jd)),
                      "pt": rgraph.point_family(jnp.asarray(c["pts"], jd))},
            factors=_ref_reproj_batches(c, jd), eliminated="pt")
        values = {"kf": jnp.asarray(c["poses"], jd),
                  "pt": jnp.asarray(c["pts"], jd)}
        H, g, Hxx, bx, P = (np.asarray(x, np.float64) for x in _jit(
            lambda: rsolve._assemble(problem, values)))
    D = H.shape[0]
    Hd = H + np.diag(lam * np.maximum(np.diag(H), 1e-6) + eps)
    dHxx = np.maximum(np.diagonal(Hxx, axis1=1, axis2=2), 1e-6)
    Hxx = Hxx + (lam * dHxx + eps)[..., None] * np.eye(3)
    Lc = np.linalg.cholesky(Hxx)
    B = np.linalg.solve(Lc, P.reshape(N_PTS, 3, D))
    cc = np.linalg.solve(Lc, bx[..., None])[..., 0]
    S_ref = Hd - np.einsum("nrd,nre->de", B, B)
    rhs_ref = -g + np.einsum("nrd,nr->d", B, cc)

    td = getattr(torch, dtype)
    Hp, gp, pairs, rhs, _ = lmk.lm_reproj_reduce_torch(
        tp.t(c["poses"]).to(td), tp.t(c["pts"]).to(td), _port_rows(c),
        tp.t(CAM).to(td), torch.tensor(BF, dtype=td),
        torch.tensor(lam, dtype=td), D)
    S = Hp + torch.diag(lam * torch.clamp(torch.diagonal(Hp), min=1e-6)
                        + eps) - pairs
    rhs_p = -gp + rhs
    tol = 1e-6 if dtype == "float64" else 1e-4
    d = np.diag(S_ref)
    assert _scaled_err(S.double().numpy(), S_ref, d) <= tol
    assert _scaled_err(rhs_p.double().numpy(), rhs_ref, d) <= tol
    # the case's rows did reach every branch
    assert c["stereo"].any() and (~c["stereo"]).any()


@functools.lru_cache(maxsize=None)
def imu_case(seed: int = 1, n: int = L_SLOTS):
    """``n`` slots joined by n - 1 preintegrations of random 200 Hz
    samples, with velocities and biases."""
    rng = np.random.default_rng(seed)
    pres = []
    for e in range(n - 1):
        T = 64
        om = (rng.normal(size=(T, 3)) * 0.3).astype(np.float32)
        ac = (rng.normal(size=(T, 3)) + [0, 0, 9.8]).astype(np.float32)
        dts = np.full(T, 0.005, np.float32)
        dts[20 + 4 * e:] = 0
        pres.append(_preintegrate(
            jnp.asarray(om), jnp.asarray(ac), jnp.asarray(dts),
            jnp.asarray(np.arange(T) < 20 + 4 * e),
            jnp.asarray((rng.normal(size=3) * 0.01).astype(np.float32)),
            jnp.asarray((rng.normal(size=3) * 0.05).astype(np.float32))))
    stacked = jax.tree.map(lambda *a: np.asarray(jnp.stack(a)), *pres)
    return dict(pre=stacked, T_bc=_poses(rng, 1, 0.05)[0],
                vel=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
                bg=(rng.normal(size=(n, 3)) * 0.01).astype(np.float32),
                ba=(rng.normal(size=(n, 3)) * 0.05).astype(np.float32),
                valid=np.array([True] * (n - 2) + [False, True])[-(n - 1):])


_preintegrate = jax.jit(rpre.preintegrate)


def _ref_imu_const(k, E, gs):
    pre = k["pre"]
    const = {f: jnp.asarray(getattr(pre, f)) for f in (
        "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt", "bias_g",
        "bias_a")}
    const["sqrt_info"] = jax.vmap(rinit._sqrt_info)(jnp.asarray(pre.cov))
    const["T_bc"] = jnp.asarray(np.broadcast_to(k["T_bc"], (E, 7)))
    if not gs:
        const["g_w"] = jnp.asarray(np.broadcast_to(
            np.float32([0, 0, -9.81]), (E, 3)))
    return const


def _walk_info(k):
    dtv = np.maximum(k["pre"].dt, 1e-3)
    return (np.float32(1.0 / (WALK_G * WALK_G * dtv)),
            np.float32(1.0 / (WALK_A * WALK_A * dtv)))


def _port_imu(k, gs, poses=None):
    E = k["pre"].dt.shape[0]
    i = np.arange(E, dtype=np.int32)
    pre = ppre.pack(interop.preint_from_numpy(k["pre"]._asdict()))
    info_g, info_a = _walk_info(k)
    return lmk.ImuRows(
        pre=pre, edge=tp.t(np.stack([i, i + 1], 1)), valid=tp.t(k["valid"]),
        T_bc=tp.t(k["T_bc"]), gs=gs,
        info_g=None if gs else tp.t(info_g),
        info_a=None if gs else tp.t(info_a),
        poses=None if poses is None else tp.t(poses), prior=1e4)


def _ref_imu_batches(k, gs):
    E = k["pre"].dt.shape[0]
    i = np.arange(E, dtype=np.int32)
    j, z = i + 1, np.zeros(E, np.int32)
    const = _ref_imu_const(k, E, gs)
    ones = jnp.ones((E,), jnp.float32)
    valid = jnp.asarray(k["valid"])
    if not gs:
        batches = [rgraph.FactorBatch(
            ("kf", "kf", "vel", "vel", "bg", "ba"), rfac.imu_factor, 9,
            jnp.asarray(np.stack([i, j, i, j, j, j], 1)), const, ones, valid,
            huber=9.0)]
        for fam, info in zip(("bg", "ba"), _walk_info(k)):
            batches.append(rgraph.FactorBatch(
                (fam, fam), rfac.bias_walk, 3, jnp.asarray(np.stack([i, j],
                                                                    1)), {},
                jnp.asarray(info), valid))
        return batches
    batches = [rgraph.FactorBatch(
        ("pose", "pose", "vel", "vel", "bg", "ba", "gdir", "scale"),
        rfac.imu_factor_gs, 9, jnp.asarray(np.stack([i, j, i, j, z, z, z, z],
                                                    1)), const, ones, valid)]
    for fam in ("bg", "ba"):
        batches.append(rgraph.FactorBatch(
            (fam,), rfac.prior_3, 3, jnp.zeros((1, 1), jnp.int32),
            {"mean": jnp.zeros((1, 3), jnp.float32)},
            jnp.full((1,), 1e4, jnp.float32), jnp.ones((1,), bool)))
    return batches


def _gdir_scale():
    q = np.asarray(rlie.quat_normalize(jnp.asarray([0.95, 0.2, -0.2, 0.1],
                                                   jnp.float32)))
    return q[None].astype(np.float32), np.float32([[1.05]])


@pytest.mark.parametrize("variant", ["vi", "init"])
def test_inertial_assemble_twin(variant):
    # K22b's twin: the dense H, g of imu_factor (Huber 9) + the two bias
    # walks (the VI BA), or imu_factor_gs + the two bias priors (the
    # initialisation, its fixed poses compacted out of the layout), against
    # the reference's _assemble of its own linearize_batch blocks, both in
    # float32; each entry scaled by sqrt(H_ii H_jj): 1e-4 (the bias walks'
    # information ~1e10 beside O(1) entries; so3_log's small-angle terms
    # round an ulp apart); the costs within 1e-5
    gs = variant == "init"
    k = imu_case()
    rng = np.random.default_rng(2)
    poses = _poses(rng, L_SLOTS, 0.3)
    q, s = _gdir_scale()
    with jax.enable_x64(False):
        if gs:
            fams = {"pose": rgraph.se3_family(jnp.asarray(poses)),
                    "vel": rgraph.point_family(jnp.asarray(k["vel"])),
                    "bg": rgraph.point_family(jnp.asarray(k["bg"][:1])),
                    "ba": rgraph.point_family(jnp.asarray(k["ba"][:1])),
                    "gdir": rgraph.VarFamily(
                        values=jnp.asarray(q), fixed=jnp.zeros((1,), bool),
                        tangent_dim=2, retract=rfac.gdir_retract),
                    "scale": rgraph.VarFamily(
                        values=jnp.asarray(s), fixed=jnp.zeros((1,), bool),
                        tangent_dim=1, retract=rfac.scale_retract)}
        else:
            fams = {"kf": rgraph.se3_family(jnp.asarray(poses)),
                    "vel": rgraph.point_family(jnp.asarray(k["vel"])),
                    "bg": rgraph.point_family(jnp.asarray(k["bg"])),
                    "ba": rgraph.point_family(jnp.asarray(k["ba"]))}
        problem = rgraph.GraphProblem(families=fams,
                                      factors=_ref_imu_batches(k, gs))
        values = {n: f.values for n, f in fams.items()}
        H, g, cost = _jit(lambda: (*rsolve._assemble(problem, values)[:2],
                                   rsolve.problem_cost(problem, values)))
        H, g = np.asarray(H, np.float64), np.asarray(g, np.float64)
        cost = float(cost)
    skip = 6 * L_SLOTS if gs else 0
    H, g = H[skip:, skip:], g[skip:]
    if gs:
        red = lmk.Reduced(vel=tp.t(k["vel"]), bg=tp.t(k["bg"][:1]),
                          ba=tp.t(k["ba"][:1]), gdir=tp.t(q), scale=tp.t(s))
        imu = _port_imu(k, True, poses)
    else:
        red = lmk.Reduced(pose=tp.t(poses), vel=tp.t(k["vel"]),
                          bg=tp.t(k["bg"]), ba=tp.t(k["ba"]))
        imu = _port_imu(k, False)
    pH, pg = lmk.lm_inertial_assemble_torch(imu, red)
    p_cost = float(lmk.lm_inertial_cost_torch(imu, red))
    d = np.diag(H)
    assert pH.shape == H.shape == (lmk.offsets(red)["D"],) * 2
    assert _scaled_err(pH.double().numpy(), H, d) <= 1e-4
    assert _scaled_err(pg.double().numpy(), g, d) <= 1e-4
    assert p_cost == pytest.approx(cost, rel=1e-5)
    # an invalid edge adds nothing: its slots' pose / velocity blocks are
    # empty when no other edge touches them
    assert not k["valid"].all()


def test_solve_step_twin():
    # K22c's twin after K22a's and K22b's (the whole step of one LM
    # iteration): the reduced families' deltas and the points' deltas
    # against the reference's _solve_step on the same VI-shaped problem
    # (4 slots of pose, velocity and biases, 64 points, slot 0 and two
    # points fixed), in float64 so that the comparison is of the algebra:
    # 1e-7 of the largest delta (the Cholesky of a system whose entries
    # span ~10 orders of magnitude, factorised by LAPACK in one package and
    # XLA in the other); the candidate poses, retracted from deltas that
    # agree to that, within 1e-7
    c = reproj_case()
    k = imu_case()
    lam = 1e-3
    f64 = jnp.float64
    fixed = jnp.asarray(c["kf_fixed"])
    fams = {"kf": rgraph.se3_family(jnp.asarray(c["poses"], f64), fixed),
            "vel": rgraph.point_family(jnp.asarray(k["vel"], f64), fixed),
            "bg": rgraph.point_family(jnp.asarray(k["bg"], f64), fixed),
            "ba": rgraph.point_family(jnp.asarray(k["ba"], f64), fixed),
            "pt": rgraph.point_family(jnp.asarray(c["pts"], f64),
                                      jnp.asarray(c["pt_fixed"]))}
    imu_b = [dataclasses.replace(
        b, const=jax.tree.map(lambda a: jnp.asarray(a, f64), b.const),
        info=jnp.asarray(b.info, f64)) for b in _ref_imu_batches(k, False)]
    problem = rgraph.GraphProblem(
        families=fams, factors=_ref_reproj_batches(c, f64) + imu_b,
        eliminated="pt")
    values = {n: f.values for n, f in fams.items()}
    deltas = _jit(lambda: rsolve._solve_step(
        problem, values, jnp.asarray(lam, f64),
        rsolve._reduced_fixed_mask(problem)))
    deltas = {n: np.asarray(v) for n, v in deltas.items()}

    d64 = torch.float64
    red = lmk.Reduced(pose=tp.t(c["poses"]).to(d64),
                      vel=tp.t(k["vel"]).to(d64), bg=tp.t(k["bg"]).to(d64),
                      ba=tp.t(k["ba"]).to(d64))
    kf_fixed = tp.t(c["kf_fixed"])
    free = lmk.free_mask(red, {n: kf_fixed for n in ("pose", "vel", "bg",
                                                     "ba")})
    imu = _port_imu(k, False)
    imu = imu._replace(pre=imu.pre.to(d64), T_bc=imu.T_bc.to(d64),
                       info_g=imu.info_g.to(d64), info_a=imu.info_a.to(d64))
    pts = tp.t(c["pts"]).to(d64)
    rows = _port_rows(c)._replace(uvr=tp.t(c["uvr"]).to(d64))
    cam, bf = tp.t(CAM).to(d64), torch.tensor(BF, dtype=d64)
    lam_t = torch.tensor(lam, dtype=d64)
    D = lmk.offsets(red)["D"]
    H, g, pairs, rhs, st = lmk.lm_reproj_reduce_torch(red.pose, pts, rows,
                                                      cam, bf, lam_t, D)
    H, g = lmk.lm_inertial_assemble_torch(imu, red, H, g)
    dx, cand = lmk.lm_solve_torch(H, g, pairs, rhs, free, lam_t, red)
    pts_c, _ = lmk.lm_reproj_cost_torch(cand.pose, pts, tp.t(c["pt_fixed"]),
                                        rows, cam, bf, st, dx)
    offs = lmk.offsets(red)
    for ref_name, name in (("kf", "pose"), ("vel", "vel"), ("bg", "bg"),
                           ("ba", "ba")):
        t = lmk.TANGENT[name]
        got = dx[offs[name]:offs[name] + L_SLOTS * t].reshape(L_SLOTS, t)
        want = deltas[ref_name]
        assert np.abs(got.numpy() - want).max() <= 1e-7 * np.abs(want).max()
    want = deltas["pt"]
    assert np.abs((pts_c - pts).numpy() - want).max() \
        <= 1e-7 * np.abs(want).max()
    # the candidates are the retractions of those deltas
    np.testing.assert_allclose(
        cand.pose.numpy(), np.asarray(rlie.se3_boxplus(
            jnp.asarray(c["poses"], f64), jnp.asarray(deltas["kf"]))),
        rtol=0, atol=1e-7)
    assert (dx[:6].abs() == 0).all()  # slot 0 is the gauge


def test_solve_twin_gauge_and_failure():
    # K22c's twin alone: fixed columns become identity rows with zero rhs
    # (their step is exactly 0 while the free step solves the free block),
    # and a system whose Cholesky fails (a NaN) gives a zero step, as the
    # engine's where(isfinite & ok) does
    rng = np.random.default_rng(3)
    A = rng.normal(size=(9, 9))
    H = torch.from_numpy(A @ A.T + 9 * np.eye(9))
    g = torch.from_numpy(rng.normal(size=9))
    red = lmk.Reduced(vel=torch.zeros((3, 3), dtype=torch.float64))
    free = torch.tensor([True] * 3 + [False] * 3 + [True] * 3)
    lam = torch.tensor(1e-4, dtype=torch.float64)
    dx, cand = lmk.lm_solve_torch(H, g, None, None, free, lam, red)
    f = free.numpy()
    Hd = H.numpy() + np.diag(1e-4 * np.maximum(np.diag(H.numpy()), 1e-6)
                             + 1e-8)
    want = np.linalg.solve(Hd[np.ix_(f, f)], -g.numpy()[f])
    np.testing.assert_allclose(dx.numpy()[f], want, rtol=1e-12, atol=1e-14)
    assert (dx.numpy()[~f] == 0).all()
    np.testing.assert_array_equal(cand.vel.numpy().reshape(-1), dx.numpy())
    H[4, 4] = float("nan")
    H[0, 0] = float("nan")
    dx, _ = lmk.lm_solve_torch(H, g, None, None, free, lam, red)
    assert (dx == 0).all()


def _linear(values, const):
    """r = J x + c: the seeded system as one factor over a D-vector."""
    return const["J"] @ values[0] + const["c"]


@pytest.mark.parametrize("D", [16, 17, 150])
def test_solve_twin_seeded_systems(D):
    # K22c's twin on the seeded systems the card holds the kernel to
    # (selfcheck.lm_solve_system: SPD, H's diagonal spanning ~1e-10 to 1e7,
    # the gauge fixed; one tile, a tile and a row, the VI BA's size)
    # against the reference's _solve_step in float64 on the same system,
    # posed as one linear factor r = J x + c over a D-vector (H = J^T J,
    # g = J^T c): 1e-7 of the largest delta, as test_solve_step_twin (the
    # Cholesky of a system spanning ~17 orders of magnitude, factorised by
    # LAPACK in one package and XLA in the other); fixed columns exactly 0
    s = selfcheck.lm_solve_system(D)
    f64 = jnp.float64
    fam = rgraph.VarFamily(values=jnp.zeros((1, D), f64),
                           fixed=jnp.zeros((1,), bool), tangent_dim=D,
                           retract=lambda v, d: v + d)
    batch = rgraph.FactorBatch(
        ("x",), _linear, D, jnp.zeros((1, 1), jnp.int32),
        {"J": jnp.asarray(s["J"])[None], "c": jnp.asarray(s["c"])[None]},
        jnp.ones((1,), f64), jnp.ones((1,), bool))
    problem = rgraph.GraphProblem(families={"x": fam}, factors=[batch])
    lam = selfcheck.LM_LAM
    want = np.asarray(_jit(lambda: rsolve._solve_step(
        problem, {"x": fam.values}, jnp.asarray(lam, f64),
        jnp.asarray(s["free"])))["x"])[0]
    H, g, free, _, red = selfcheck.lm_solve_operands(s, "cpu")
    red = lmk.Reduced(*(None if v is None else v.double() for v in red))
    dx, cand = lmk.lm_solve_torch(H, g, None, None, free,
                                  torch.tensor(lam, dtype=torch.float64), red)
    assert np.abs(dx.numpy() - want).max() <= 1e-7 * np.abs(want).max()
    assert (dx.numpy()[~s["free"]] == 0).all()
    assert (dx.numpy()[s["free"]] != 0).all()
    np.testing.assert_array_equal(
        torch.cat([c.reshape(-1) for c in cand if c is not None]).isfinite(),
        True)


def test_route_matches_generic_engine_on_vi_local_ba():
    # the whole route (the twins) against the port's generic LM engine on
    # test_vi_local_ba's inputs (the reference's state before its second
    # VI local BA, 6 iterations): that test's tolerances, poses within
    # 1e-4, points within 1e-3 m, velocities within 1e-3 m/s, biases
    # within 1e-4, the final cost within 1e-3
    from test_torch_vi_slice import vi_reference_state
    s = vi_reference_state()
    cfg = s["cfg"]
    imu_state = interop.imu_state_from_numpy(
        {**s["imu"]._asdict(), "preint": s["imu"].preint._asdict()})
    m = interop.map_from_numpy(tp.to_np(s["map"]))
    kf_ids, kf_mask, safe_pt, pt_ok, prob = pvba.vi_problem(
        m, imu_state, s["kf"], tp.t(np.asarray(cfg.camera.K)),
        torch.tensor(np.float32(cfg.camera.bf)),
        tp.t(np.float32(cfg.imu.T_bc)), WALK_G, WALK_A, 10, 4096)
    res = lmk.optimize_reproj_inertial(iters=6, **prob)

    red = prob["red"]
    slot_fixed = ~prob["free"][:6 * 10:6]
    problem = pgraph.GraphProblem(
        families={"kf": pgraph.se3_family(red.pose, slot_fixed),
                  "vel": pgraph.point_family(red.vel, slot_fixed),
                  "bg": pgraph.point_family(red.bg, slot_fixed),
                  "ba": pgraph.point_family(red.ba, slot_fixed),
                  "pt": pgraph.point_family(prob["pts"], prob["pt_fixed"])},
        factors=(pmap.reproj_batches(prob["rows"], prob["cam"], prob["bf"])
                 + list(lmk._inertial_problem(prob["imu"],
                                              red)[0].factors)),
        eliminated="pt")
    gen = psolve.optimize(problem, iters=6)
    v = gen.values
    ok = kf_mask.numpy()
    np.testing.assert_allclose(res.red.pose.numpy()[ok], v["kf"].numpy()[ok],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.pts.numpy(), v["pt"].numpy(), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(res.red.vel.numpy(), v["vel"].numpy(),
                               rtol=0, atol=1e-3)
    for a, b in ((res.red.bg, v["bg"]), (res.red.ba, v["ba"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
    assert float(res.cost) == pytest.approx(float(gen.cost), rel=1e-3)
    assert float(res.cost) < float(res.initial_cost)
    assert math.isfinite(float(res.cost))
