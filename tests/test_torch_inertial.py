"""Port parity of the inertial layer: the K18 twin (preintegration and its
merge), the inertial factors on the generic engine, the initialisation,
the K20 twin (the per-frame visual-inertial solve), K6's pose-prior
branch and the synthetic IMU stream, each against the
reference on the same numpy inputs.  Float32 stays float32: the reference
integrates in float32, and its solves run with JAX in float32 here
(``jax.enable_x64(False)``; the conftest turns float64 on)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from visual_sgraphs_tpu.config import ImuConfig as RefImuConfig
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.inertial import factors as rfac
from visual_sgraphs_tpu.inertial import init as rinit
from visual_sgraphs_tpu.inertial import pipeline as rpipe
from visual_sgraphs_tpu.inertial import preintegration as rpre
from visual_sgraphs_tpu.io.synthetic import SyntheticScene as RefScene
from visual_sgraphs_tpu.optim import graph as rgraph
from visual_sgraphs_tpu.slam import tracking as rtrack
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.config import ImuConfig
from visual_sgraphs_tpu_torch.core import cameras as pcam
from visual_sgraphs_tpu_torch.core import lie as plie
from visual_sgraphs_tpu_torch.inertial import factors as pfac
from visual_sgraphs_tpu_torch.inertial import init as pinit
from visual_sgraphs_tpu_torch.inertial import pipeline as ppipe
from visual_sgraphs_tpu_torch.inertial import preintegration as ppre
from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene as PortScene
from visual_sgraphs_tpu_torch.optim import graph as pgraph
from visual_sgraphs_tpu_torch.slam import tracking as ptrack

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")


def _rel_err(a, b) -> float:
    """max |a - b| relative to max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _samples(rng, T=64, n=50, dt=0.005):
    om = (rng.normal(size=(T, 3)) * 0.5).astype(np.float32)
    ac = (rng.normal(size=(T, 3)) * 2 + [0, 9.8, 0]).astype(np.float32)
    dts = np.full(T, dt, np.float32)
    dts[n:] = 0
    return om, ac, dts, np.arange(T) < n


def _ref_preint(om, ac, dts, valid, bg, ba):
    return rpre.preintegrate(jnp.asarray(om), jnp.asarray(ac),
                             jnp.asarray(dts), jnp.asarray(valid),
                             jnp.asarray(bg), jnp.asarray(ba))


def _port_preint(r):
    return interop.preint_from_numpy(tp.to_np(r))


def _assert_preint_close(p, r, tol: float = 1e-5):
    # ΔR, ΔV, ΔP and the bias Jacobians within ``tol`` of each field's
    # largest entry (float32 sums in another order, 1-ulp differences of
    # sin / cos in the small-angle terms); the covariance within 1e-4 of
    # its largest entry; the integration time exactly (the same float32
    # sums in order)
    for f in FIELDS:
        assert _rel_err(getattr(p, f).numpy(), getattr(r, f)) <= tol, f
    assert _rel_err(p.cov.numpy(), r.cov) <= 1e-4
    assert p.dt.numpy() == np.asarray(r.dt)
    np.testing.assert_array_equal(p.bias_g.numpy(), np.asarray(r.bias_g))


@pytest.fixture(scope="module")
def preints():
    rng = np.random.default_rng(0)
    bg = (rng.normal(size=3) * 0.01).astype(np.float32)
    ba = (rng.normal(size=3) * 0.05).astype(np.float32)
    first, second = _samples(rng), _samples(rng, n=37)
    r_since = _ref_preint(*first, bg, ba)
    r_win = _ref_preint(*second, bg, ba)
    return dict(bg=bg, ba=ba, samples=second, r_since=r_since, r_win=r_win,
                r_merged=rpre.merge(r_since, r_win))


def test_preintegrate_merge_twin(preints):
    # K18's twin: the 64-row window (37 valid rows, non-zero biases) and
    # its merge into a keyframe window, against the reference's scan and
    # merge
    om, ac, dts, valid = preints["samples"]
    win, merged = ppre.preintegrate_merge(
        _port_preint(preints["r_since"]),
        ppre.sample_table(tp.t(om), tp.t(ac), tp.t(dts), tp.t(valid)),
        tp.t(preints["bg"]), tp.t(preints["ba"]))
    _assert_preint_close(win, preints["r_win"])
    _assert_preint_close(merged, preints["r_merged"])


def test_preintegrate_twin_matches_reference_scan(preints):
    # the reference's own entry point, window only
    om, ac, dts, valid = preints["samples"]
    p = ppre.preintegrate(tp.t(om), tp.t(ac), tp.t(dts), tp.t(valid),
                          tp.t(preints["bg"]), tp.t(preints["ba"]))
    _assert_preint_close(p, preints["r_win"])


def test_preint_pack_round_trip(preints):
    p = _port_preint(preints["r_merged"])
    vec = ppre.pack(p)
    assert vec.shape == (ppre.PACKED,)
    back = ppre.unpack(vec)
    for a, b in zip(p, back):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bias_corrected_delta(preints):
    # 1e-6 relative: a handful of float32 operations
    bg = preints["bg"] + np.float32(2e-3)
    ba = preints["ba"] - np.float32(1e-2)
    r = rpre.bias_corrected_delta(preints["r_win"], jnp.asarray(bg),
                                  jnp.asarray(ba))
    p = ppre.bias_corrected_delta(_port_preint(preints["r_win"]), tp.t(bg),
                                  tp.t(ba))
    for a, b in zip(p, r):
        assert _rel_err(a.numpy(), b) <= 1e-6


def _poses(rng, n, scale=0.3):
    xi = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    return np.asarray(jax.vmap(rlie.se3_exp)(jnp.asarray(xi)), np.float32)


def test_predict_state(preints):
    # 1e-5 relative: the same float32 arithmetic, summed in another order
    rng = np.random.default_rng(3)
    T_cw, T_bc = _poses(rng, 2)
    v = np.float32([0.3, -0.2, 0.5])
    rT, rv = rpipe.predict_state(jnp.asarray(T_cw), jnp.asarray(v),
                                 preints["r_win"], jnp.asarray(T_bc))
    pT, pv = ppipe.predict_state(tp.t(T_cw), tp.t(v),
                                 _port_preint(preints["r_win"]), tp.t(T_bc))
    assert _rel_err(pT.numpy(), rT) <= 1e-5
    assert _rel_err(pv.numpy(), rv) <= 1e-5


def test_visual_velocity():
    # 1e-5 relative
    rng = np.random.default_rng(4)
    T_a, T_b, T_bc = _poses(rng, 3)
    r = rpipe._visual_velocity(jnp.asarray(T_a), jnp.asarray(T_b),
                               jnp.asarray(T_bc), jnp.asarray(0.0333,
                                                              jnp.float32))
    p = ppipe._visual_velocity(tp.t(T_a), tp.t(T_b), tp.t(T_bc), 0.0333)
    assert _rel_err(p.numpy(), r) <= 1e-5


# ---------------------------------------------------------------------------
# factors on the generic engine
# ---------------------------------------------------------------------------


def _factor_setup(kind: str):
    """The same (m = 4)-item factor batch and families in both packages."""
    rng = np.random.default_rng(5)
    m = 4
    pres = [_ref_preint(*_samples(rng, n=20 + 5 * i),
                        (rng.normal(size=3) * 0.01).astype(np.float32),
                        (rng.normal(size=3) * 0.05).astype(np.float32))
            for i in range(m)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *pres)
    poses = _poses(rng, m + 1, 0.2)
    vel = (rng.normal(size=(m + 1, 3)) * 0.5).astype(np.float32)
    bgs = (rng.normal(size=(m + 1, 3)) * 0.01).astype(np.float32)
    bas = (rng.normal(size=(m + 1, 3)) * 0.05).astype(np.float32)
    T_bc = _poses(rng, 1, 0.05)[0]
    i = np.arange(m, dtype=np.int32)
    j = i + 1
    z = np.zeros(m, np.int32)
    sqrt_info = np.asarray(jax.vmap(rinit._sqrt_info)(stacked.cov))
    const = {k: np.asarray(getattr(stacked, k)) for k in (
        "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt",
        "bias_g", "bias_a")}
    const.update(sqrt_info=sqrt_info,
                 T_bc=np.broadcast_to(T_bc, (m, 7)).copy())
    q_wg = np.asarray(rlie.quat_normalize(jnp.asarray([0.9, 0.3, -0.2, 0.1],
                                                      jnp.float32)))
    fam_vals = {"pose": poses, "vel": vel, "bg": bgs, "ba": bas,
                "gdir": q_wg[None], "scale": np.float32([[1.1]])}
    if kind == "imu_factor":
        const["g_w"] = np.broadcast_to(np.float32([0, 0, -9.81]),
                                       (m, 3)).copy()
        spec = (("pose", "pose", "vel", "vel", "bg", "ba"),
                np.stack([i, j, i, j, j, j], 1), 9, 9.0)
    elif kind == "imu_factor_gs":
        spec = (("pose", "pose", "vel", "vel", "bg", "ba", "gdir", "scale"),
                np.stack([i, j, i, j, z, z, z, z], 1), 9, None)
    elif kind == "bias_walk":
        const = {}
        spec = (("bg", "bg"), np.stack([i, j], 1), 3, None)
    else:
        const = {"mean": (rng.normal(size=(m, 3)) * 0.01).astype(np.float32)}
        spec = (("ba",), i[:, None], 3, None)
    return fam_vals, const, spec


def _ref_families(fam_vals):
    f = {k: rgraph.point_family(jnp.asarray(v))
         for k, v in fam_vals.items() if k in ("vel", "bg", "ba")}
    f["pose"] = rgraph.se3_family(jnp.asarray(fam_vals["pose"]))
    f["gdir"] = rgraph.VarFamily(values=jnp.asarray(fam_vals["gdir"]),
                                 fixed=jnp.zeros((1,), bool), tangent_dim=2,
                                 retract=rfac.gdir_retract)
    f["scale"] = rgraph.VarFamily(values=jnp.asarray(fam_vals["scale"]),
                                  fixed=jnp.zeros((1,), bool), tangent_dim=1,
                                  retract=rfac.scale_retract)
    return f


def _port_families(fam_vals):
    f = {k: pgraph.point_family(tp.t(v))
         for k, v in fam_vals.items() if k in ("vel", "bg", "ba")}
    f["pose"] = pgraph.se3_family(tp.t(fam_vals["pose"]))
    f["gdir"] = pgraph.gdir_family(tp.t(fam_vals["gdir"]))
    f["scale"] = pgraph.scale_family(tp.t(fam_vals["scale"]))
    return f


@pytest.mark.parametrize("kind", ["imu_factor", "imu_factor_gs",
                                  "bias_walk", "prior_3"])
def test_inertial_factor_linearisation(kind):
    # whitened residuals and their forward-mode Jacobians through each
    # family's retraction, within 1e-4 of each array's largest entry (the
    # preintegration rows are whitened by sqrt informations ~1e4, and
    # float32 rounding of so3_log's small-angle terms differs by an ulp);
    # the robust weights within 1e-5
    fam_vals, const, (fams, var_idx, res_dim, huber) = _factor_setup(kind)
    fn = {"imu_factor": (rfac.imu_factor, pfac.imu_factor),
          "imu_factor_gs": (rfac.imu_factor_gs, pfac.imu_factor_gs),
          "bias_walk": (rfac.bias_walk, pfac.bias_walk),
          "prior_3": (rfac.prior_3, pfac.prior_3)}[kind]
    m = var_idx.shape[0]
    info = np.float32([1.0, 2.0, 0.5, 3.0])[:m]
    valid = np.array([True, True, False, True])[:m]
    with jax.enable_x64(False):
        rb = rgraph.FactorBatch(
            families=fams, residual_fn=fn[0], res_dim=res_dim,
            var_idx=jnp.asarray(var_idx),
            const={k: jnp.asarray(v) for k, v in const.items()},
            info=jnp.asarray(info), valid=jnp.asarray(valid), huber=huber)
        r_r, r_j, r_w = rgraph.linearize_batch(rb, _ref_families(fam_vals))
        r_r, r_w = np.asarray(r_r), np.asarray(r_w)
        r_j = [np.asarray(j) for j in r_j]
    pb = pgraph.FactorBatch(fams, fn[1], res_dim, tp.t(var_idx),
                            {k: tp.t(v) for k, v in const.items()},
                            tp.t(info), tp.t(valid), huber=huber)
    p_r, p_j, p_w = pgraph.linearize_batch(pb, _port_families(fam_vals))
    assert _rel_err(p_r.numpy(), r_r) <= 1e-4
    for a, b in zip(p_j, r_j):
        assert a.shape == b.shape
        assert _rel_err(a.numpy(), b) <= 1e-4
    np.testing.assert_allclose(p_w.numpy(), r_w, rtol=1e-5, atol=0)


def test_sqrt_info_and_guard():
    # the lower-Cholesky inverse within 1e-5 of its largest entry, and the
    # identity for a covariance that is not positive definite
    rng = np.random.default_rng(6)
    A = rng.normal(size=(9, 9)) * 1e-3
    cov = np.stack([A @ A.T + np.eye(9) * 1e-6, -np.eye(9)]).astype(
        np.float32)
    with jax.enable_x64(False):
        r = np.asarray(jax.vmap(rinit._sqrt_info)(jnp.asarray(cov)))
    p = pinit.sqrt_info(tp.t(cov)).numpy()
    assert _rel_err(p[0], r[0]) <= 1e-5
    np.testing.assert_array_equal(p[1], np.eye(9, dtype=np.float32))
    np.testing.assert_array_equal(r[1], np.eye(9, dtype=np.float32))


# ---------------------------------------------------------------------------
# the synthetic IMU stream and the host pipeline
# ---------------------------------------------------------------------------


def _imu_streams(kind: str, imu_rate: float = 240.0):
    kw = dict(kind=kind, fps=30.0, imu_rate=imu_rate)
    ref = [(T, ts, s) for _, _, T, ts, s in
           RefScene(h=16, w=16).frames_with_imu(30, **kw)]
    traj, samples = PortScene(h=16, w=16, device="cpu").imu_samples(30, **kw)
    return ref, traj, samples


@pytest.fixture(scope="module")
def imu_streams():
    return _imu_streams("arc")


@pytest.mark.parametrize("kind", ["orbit", "arc"])
def test_frames_with_imu_samples(kind):
    # ``orbit`` (the inertial row's trajectory, built in numpy in both
    # packages): the same frame poses, samples and times exactly.  ``arc``
    # (built through se3_exp, whose float32 results differ in the last
    # bit between the two libraries): frame poses within 1e-6, gyro
    # within 5e-5 rad/s, and the specific force within 0.05 m/s² (0.3 %
    # of its largest value): the second difference of the positions over
    # dt² = 2.5e-5 s² turns a last-bit difference of a position into
    # ~0.03 m/s².  Times exact in both.
    ref, traj, samples = _imu_streams(kind, 200.0)
    exact = kind == "orbit"
    assert len(samples) == len(ref) == 30
    for (T, _, (rw, ra, rt)), (pw, pa, pt), pT in zip(ref, samples, traj):
        assert pw.shape == rw.shape and pa.shape == ra.shape
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_allclose(pT, np.asarray(T), rtol=0,
                                   atol=0 if exact else 1e-6)
        if len(rt):
            np.testing.assert_allclose(pw, rw, rtol=0,
                                       atol=0 if exact else 5e-5)
            np.testing.assert_allclose(pa, ra, rtol=0,
                                       atol=0 if exact else 0.05)


def test_pipeline_windows_and_host_dt(imu_streams):
    # the port's pipeline and the reference's over 12 frames of the same
    # samples with a keyframe every 4: the frame and keyframe windows, and
    # the host's float32 mirrors of the frame and keyframe integration
    # times equal to the device values the reference reads back.  The
    # windows' Jacobians within 1e-4 of their largest entry: at 240 Hz a
    # step turns by ~1e-3 rad, where the right Jacobian's (1 - cos θ) / θ²
    # loses all but a few bits in float32, so a last-bit difference of the
    # two libraries' cosines moves it by several per cent (the K18 twin's
    # own test, at 200 Hz and larger rates, holds 1e-5)
    ref, _, _ = imu_streams
    rp = rpipe.ImuPipeline(RefImuConfig(), 8)
    pp = ppipe.ImuPipeline(ImuConfig(), 8, device="cpu")
    for k in range(12):
        _, ts, rs = ref[k]
        rp.add_samples(*rs)
        pp.add_samples(*rs)
        r_pre = rp.preintegrate_frame(ts)
        p_pre = pp.preintegrate_frame(ts)
        assert (r_pre is None) == (p_pre is None)
        if r_pre is not None:
            assert np.float32(pp.frame_dt) == np.asarray(r_pre.dt)
            assert pp.frame_dt == float(p_pre.dt)
            _assert_preint_close(p_pre, r_pre, 1e-4)
        assert np.float32(pp._since_kf_dt) == np.asarray(rp._since_kf.dt)
        if k % 4 == 3:
            rp.on_keyframe(k // 4)
            pp.on_keyframe(k // 4)
    np.testing.assert_array_equal(pp.state.preint_valid.numpy(),
                                  np.asarray(rp.state.preint_valid))
    _assert_preint_close(
        ppre.Preintegrated(*(f[2] for f in pp.state.preint)),
        jax.tree.map(lambda a: a[2], rp.state.preint), 1e-4)
    assert ppipe.walk_info(ImuConfig(), pp.frame_dt) == tuple(
        float(x) for x in np.asarray(jnp.asarray([
            1.0 / (1.9e-5 * np.sqrt(max(float(r_pre.dt), 1e-3))),
            1.0 / (3.0e-3 * np.sqrt(max(float(r_pre.dt), 1e-3)))],
            jnp.float32)))


def test_pipeline_state_round_trip(imu_streams):
    # the reference's export_state carried into the port and back: exact
    ref, _, _ = imu_streams
    rp = rpipe.ImuPipeline(RefImuConfig(), 8)
    for k in range(6):
        _, ts, rs = ref[k]
        rp.add_samples(*rs)
        rp.preintegrate_frame(ts)
        if k == 3:
            rp.on_keyframe(1)
    tree = jax.tree.map(np.asarray, rp.export_state())
    d = {**tree, "state": {**tree["state"]._asdict(),
                           "preint": tree["state"].preint._asdict()},
         "since_kf": tree["since_kf"]._asdict()}
    pp = ppipe.ImuPipeline(ImuConfig(), 8, device="cpu")
    pp.import_state(interop.imu_pipeline_state_from_numpy(d))
    assert pp._last_t == rp._last_t and pp.initialized == rp.initialized
    assert np.float32(pp._since_kf_dt) == np.asarray(rp._since_kf.dt)
    back = interop.imu_pipeline_state_to_numpy(pp.export_state())
    np.testing.assert_array_equal(back["state"]["preint"]["cov"],
                                  d["state"]["preint"]["cov"])
    np.testing.assert_array_equal(back["since_kf"]["dR"],
                                  d["since_kf"]["dR"])
    np.testing.assert_array_equal(back["vel"], d["vel"])


# ---------------------------------------------------------------------------
# the initialisation and the VI local BA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def init_setup():
    """The set-up of ``tests/test_inertial.py:178``: every third frame of
    30 ``arc`` frames (240 Hz IMU) a keyframe at its true pose."""
    scene = RefScene(h=64, w=64)
    pipe = rpipe.ImuPipeline(RefImuConfig(), max_keyframes=32,
                             fix_scale=True)
    poses, k = [], 0
    for _, _, T_wc, ts, samples in scene.frames_with_imu(
            30, kind="arc", fps=30.0, imu_rate=240.0):
        pipe.add_samples(*samples)
        pipe.preintegrate_frame(ts)
        if int(ts * 30 + 0.5) % 3 == 0:
            poses.append(np.asarray(rlie.se3_inverse(jnp.asarray(T_wc))))
            pipe.on_keyframe(k)
            k += 1
    n = len(poses)
    return dict(kf_pose=np.stack(poses).astype(np.float32), n=n,
                preint=jax.tree.map(lambda a: np.asarray(a[:n]),
                                    pipe.state.preint),
                preint_valid=np.asarray(pipe.state.preint_valid[:n]))


def test_inertial_init(init_setup):
    # gravity direction within 1e-3 (cosine), velocities within 1e-3 m/s,
    # biases within 1e-4: 40 float32 LM iterations of the same problem
    # (the reference's float32 solves against the port's, each step's
    # accept / reject taken on the device)
    s = init_setup
    n = s["n"]
    T_bc = np.float32([1, 0, 0, 0, 0, 0, 0])
    with jax.enable_x64(False):
        r = rinit.inertial_init(
            jnp.asarray(s["kf_pose"]), jnp.ones((n,), bool),
            jax.tree.map(jnp.asarray, s["preint"]),
            jnp.asarray(s["preint_valid"]), jnp.asarray(T_bc),
            fix_scale=True, iters=40)
        r_g = np.asarray(rfac.gravity_from_quat(r.q_wg))
    p = pinit.inertial_init(
        tp.t(s["kf_pose"]), torch.ones((n,), dtype=torch.bool),
        interop.preint_from_numpy(s["preint"]._asdict()),
        tp.t(s["preint_valid"]), tp.t(T_bc), fix_scale=True, iters=40)
    p_g = pfac.gravity_from_quat(p.q_wg).numpy()
    assert float(p.cost) < float(p.cost0)
    cos = p_g @ r_g / (np.linalg.norm(p_g) * np.linalg.norm(r_g))
    assert cos > 1 - 1e-3, (p_g, r_g)
    assert p_g @ np.float32([0, 9.81, 0]) / (9.81 * np.linalg.norm(p_g)) \
        > 0.99
    np.testing.assert_allclose(p.vel.numpy(), np.asarray(r.vel), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(p.bias_g.numpy(), np.asarray(r.bias_g),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.bias_a.numpy(), np.asarray(r.bias_a),
                               rtol=0, atol=1e-4)


def test_apply_scaled_rotation_and_velocities():
    # 1e-5 relative: a rotation and a scale of every pose, point, velocity
    snap = tp.snapshot(10)
    q_wg = np.asarray(rlie.quat_normalize(jnp.asarray(
        [0.9, 0.3, -0.2, 0.1], jnp.float32)))
    s = np.float32(1.3)
    r = rinit.apply_scaled_rotation(snap["map"], jnp.asarray(q_wg),
                                    jnp.asarray(s))
    p = pinit.apply_scaled_rotation(tp.port_map(snap["map"]), tp.t(q_wg),
                                    torch.tensor(s))
    assert _rel_err(p.kf_pose.numpy(), r.kf_pose) <= 1e-5
    assert _rel_err(p.pt_pos.numpy(), r.pt_pos) <= 1e-5
    vel = np.float32([[0.3, -0.1, 0.2], [1.0, 0.5, -0.4]])
    rv = rinit.rotate_velocities(jnp.asarray(vel), jnp.asarray(q_wg),
                                 jnp.asarray(s))
    pv = pinit.rotate_velocities(tp.t(vel), tp.t(q_wg), torch.tensor(s))
    assert _rel_err(pv.numpy(), rv) <= 1e-5


# ---------------------------------------------------------------------------
# the per-frame solve (K20's twin) and K6's pose prior
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vi_solve_inputs():
    """Frame 10 of the mid-stream snapshot tracked by the reference, the
    preintegration of its IMU samples (rendered for a world with gravity
    along -z, the frame the solve assumes after the initialisation), the
    last frame's pose as T_i and the true velocity as v_i."""
    snap = tp.snapshot(10)
    cfg = snap["cfg"]
    T_last = snap["last_pose"]
    T_pred = np.asarray(rlie.se3_normalize(rlie.se3_multiply(
        jnp.asarray(snap["velocity"]), jnp.asarray(T_last))), np.float32)
    res, _, _ = rtrack.track_frame_full(
        snap["map"], snap["frame"], jnp.asarray(T_pred), jnp.asarray(T_last),
        jnp.asarray(snap["ref_kf"], jnp.int32), jnp.asarray(cfg.camera.K),
        jnp.asarray(15, jnp.int32), n_window=10, fx_radius=15.0,
        fine_radius=7.0, cam_bf=jnp.asarray(np.float32(cfg.camera.bf)),
        img_wh=(cfg.camera.width, cfg.camera.height))
    frames = list(RefScene(h=16, w=16).frames_with_imu(
        11, kind="arc", g_world=(0.0, 0.0, -9.81)))
    om, ac, t = frames[10][4]
    t_prev = frames[9][4][2][-1]
    dts = np.diff(np.concatenate([[t_prev], t])).astype(np.float32)
    T = 64
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, np.zeros((T - len(x),) + x.shape[1:], x.dtype)])
    bg = np.float32([0.002, -0.001, 0.0005])
    ba = np.float32([0.02, 0.01, -0.03])
    with jax.enable_x64(False):
        pre = rpre.preintegrate(
            jnp.asarray(pad(om.astype(np.float32))),
            jnp.asarray(pad(ac.astype(np.float32))), jnp.asarray(pad(dts)),
            jnp.asarray(np.arange(T) < len(t)), jnp.asarray(bg),
            jnp.asarray(ba))
    T_wc = [f[2] for f in frames]
    v_i = ((T_wc[10][4:7] - T_wc[9][4:7]) * 30.0).astype(np.float32)
    walk = (float(np.float32(1.0 / (1.9e-5 * np.sqrt(float(pre.dt))))),
            float(np.float32(1.0 / (3.0e-3 * np.sqrt(float(pre.dt))))))
    return dict(snap=snap, slot_pt=np.asarray(res.slot_pt),
                T_j0=np.asarray(rlie.se3_normalize(res.pose), np.float32),
                T_i=T_last, v_i=v_i, pre=pre, walk=walk,
                K=np.asarray(cfg.camera.K), bf=np.float32(cfg.camera.bf))


def test_pose_inertial_gn_twin(vi_solve_inputs):
    # K20's twin against the reference's jacfwd-based solve: the inlier
    # count exactly, the pose within 1e-4, the velocity within 1e-3 m/s,
    # the biases within 1e-4 (the twin solves the 15x15 system in float64,
    # the reference in float32)
    s = vi_solve_inputs
    snap = s["snap"]
    T_bc = np.float32([1, 0, 0, 0, 0, 0, 0])
    with jax.enable_x64(False):
        r = rpipe.pose_inertial_gn(
            snap["map"], snap["frame"], jnp.asarray(s["slot_pt"]),
            jnp.asarray(s["T_j0"]), jnp.asarray(s["v_i"]),
            jnp.asarray(s["T_i"]), jnp.asarray(s["v_i"]), s["pre"],
            jnp.asarray(T_bc), jnp.asarray(s["K"]), jnp.asarray(s["bf"]),
            jnp.asarray(s["walk"], jnp.float32))
        r = [np.asarray(x) for x in r]
    p = ppipe.pose_inertial_gn(
        tp.port_map(snap["map"]), tp.port_frame(snap["frame"]),
        tp.t(s["slot_pt"]), tp.t(s["T_j0"]), tp.t(s["v_i"]),
        tp.t(s["T_i"]), tp.t(s["v_i"]), _port_preint(s["pre"]), tp.t(T_bc),
        tp.t(s["K"]), torch.tensor(s["bf"]), s["walk"])
    assert int(p[4]) == int(r[4]) >= 15
    np.testing.assert_allclose(p[0].numpy(), r[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p[1].numpy(), r[1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(p[2].numpy(), r[2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p[3].numpy(), r[3], rtol=0, atol=1e-4)
    # the solve moved the state
    assert np.abs(r[0] - s["T_j0"]).max() > 1e-6


def _reproj_residuals(x, T_j, xw, uv_obs, ur_obs, has_d, w, cam_K, cam_bf):
    """The reference's weighted (u, v, u_r) rows (F, 3) at exp(x[:6]) T_j
    (``visual_sgraphs_tpu/inertial/pipeline.py:311-316``), for
    ``jacfwd``."""
    p_c = plie.se3_apply(plie.se3_boxplus(T_j, x[:6]), xw)
    uv_hat = pcam.project_pinhole(cam_K, p_c)
    ur_hat = uv_hat[:, 0] - cam_bf / torch.clamp(p_c[:, 2], min=1e-6)
    r_uv = (uv_hat - uv_obs) * w[:, None]
    r_ur = torch.where(has_d, ur_hat - ur_obs, 0.0) * w
    return torch.cat([r_uv, r_ur[:, None]], dim=1)


def test_vi_reprojection_jacobian_is_analytic_jacfwd(vi_solve_inputs):
    # the analytic rows K20 and its twin use, against torch.func.jacfwd of
    # the residual rows written as the reference writes them, through
    # exp(x) T_j: 1e-4 of the largest entry (float32, fx / z² terms up to
    # ~1e5)
    s = vi_solve_inputs
    m = tp.port_map(s["snap"]["map"])
    frame = tp.port_frame(s["snap"]["frame"])
    bf = torch.tensor(s["bf"])
    K = tp.t(s["K"])
    xw, uv, ur, ok, has_d = ppipe._vi_observations(m, frame,
                                                   tp.t(s["slot_pt"]), bf)
    T_j = tp.t(s["T_j0"])
    w = ppipe.irls_weights(T_j, xw, uv, ok, K)
    assert int((w > 0).sum()) >= 15
    r, J = ppipe.reproj_rows(T_j, xw, uv, ur, has_d, w, K, bf)
    x0 = torch.zeros(6)
    r_ad = _reproj_residuals(x0, T_j, xw, uv, ur, has_d, w, K, bf)
    J_ad = jacfwd(_reproj_residuals)(x0, T_j, xw, uv, ur, has_d, w, K, bf)
    assert _rel_err(r.numpy(), r_ad.numpy()) <= 1e-6
    assert _rel_err(J.numpy(), J_ad.numpy()) <= 1e-4


def test_pose_only_gn_prior_twin(vi_solve_inputs):
    # K6's prior branch with T_prior and prior_weight = 10 against the
    # reference (pose within 1e-4, inlier flags on >= 99 % of rows, as
    # K6's own test), on the snapshot frame's matches
    rng = np.random.default_rng(7)
    s = vi_solve_inputs
    snap = s["snap"]
    m, frame = snap["map"], snap["frame"]
    slot = np.maximum(s["slot_pt"], 0)
    ok = s["slot_pt"] >= 0
    xw = np.asarray(m.pt_pos)[slot]
    uv = np.asarray(frame.uv)
    depth = np.asarray(frame.depth)
    T_init = np.asarray(rlie.se3_boxplus(jnp.asarray(s["T_j0"]), jnp.asarray(
        (rng.normal(size=6) * 0.01).astype(np.float32))), np.float32)
    T_prior = np.asarray(rlie.se3_boxplus(jnp.asarray(s["T_j0"]),
                                          jnp.asarray(np.float32(
                                              [0.02, 0, -0.01, 0.01, 0,
                                               0]))), np.float32)
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2)
    for w in (10.0, 1e4):
        rT, rin = rtrack.pose_only_gn(
            jnp.asarray(T_init), jnp.asarray(xw), jnp.asarray(uv),
            jnp.asarray(ok), jnp.asarray(s["K"]), depth=jnp.asarray(depth),
            bf=jnp.asarray(s["bf"]), T_prior=jnp.asarray(T_prior),
            prior_weight=w, **kw)
        pT, pin = ptrack.pose_only_gn_prior(
            tp.t(T_init), tp.t(xw), tp.t(uv), tp.t(ok), tp.t(s["K"]),
            tp.t(T_prior), w, depth=tp.t(depth), bf=torch.tensor(s["bf"]),
            **kw)
        np.testing.assert_allclose(pT.numpy(), np.asarray(rT), rtol=0,
                                   atol=1e-4)
        assert np.mean(pin.numpy() == np.asarray(rin)) >= 0.99
    # the heavy prior pulls the solution towards T_prior: a smaller prior
    # residual log(T T_prior⁻¹) than without it
    free, _ = ptrack.pose_only_gn(
        tp.t(T_init), tp.t(xw), tp.t(uv), tp.t(ok), tp.t(s["K"]),
        depth=tp.t(depth), bf=torch.tensor(s["bf"]), **kw)
    dist = lambda T: float(torch.linalg.norm(plie.se3_log(  # noqa: E731
        plie.se3_multiply(T, plie.se3_inverse(tp.t(T_prior))))))
    assert dist(pT) < dist(free)


def test_pose_gn_prior_check_weights():
    # the card check of K6's prior (selfcheck.check_pose_gn_prior) can
    # fail a kernel that drops the prior only where the prior moves the
    # pose: on its inputs the twin's shift (prior minus no prior) stays
    # below POSE_TOL at the main path's weight 10 and reaches
    # PRIOR_SHIFT_MIN at the dominant weight, where the twin still agrees
    # with the reference within POSE_TOL
    from visual_sgraphs_tpu_torch import selfcheck as sc
    T0, xw, uv, valid, K, depth, bf, T_prior = sc.pose_prior_inputs("cpu")
    kw = dict(iters=12, gate0=(2.0 * 15.0) ** 2, depth=depth, bf=bf)
    free, _ = ptrack.pose_only_gn(T0, xw, uv, valid, K, **kw)
    shift = {}
    for w in (sc.PRIOR_WEIGHTS[0], sc.PRIOR_WEIGHTS[-1]):
        T, _ = ptrack.pose_only_gn_prior(T0, xw, uv, valid, K, T_prior, w,
                                         **kw)
        shift[w] = float((T - free).abs().max())
    assert shift[sc.PRIOR_WEIGHTS[0]] < sc.POSE_TOL
    assert shift[sc.PRIOR_WEIGHTS[-1]] >= sc.PRIOR_SHIFT_MIN
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    rT, _ = rtrack.pose_only_gn(
        j(T0), j(xw), j(uv), j(valid), j(K), iters=12, gate0=kw["gate0"],
        depth=j(depth), bf=j(bf), T_prior=j(T_prior),
        prior_weight=sc.PRIOR_WEIGHTS[-1])
    np.testing.assert_allclose(T.numpy(), np.asarray(rT), rtol=0,
                               atol=sc.POSE_TOL)


def test_sensor_gate():
    # IMU_RGBD builds the pipeline; IMU_MONOCULAR / IMU_STEREO still raise
    from visual_sgraphs_tpu_torch.config import Sensor, SystemConfig
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem
    s = SlamSystem(SystemConfig(sensor=Sensor.IMU_RGBD), device="cpu")
    assert isinstance(s.imu, ppipe.ImuPipeline) and not s.imu.initialized
    assert SlamSystem(SystemConfig(), device="cpu").imu is None
    for sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO):
        with pytest.raises(NotImplementedError):
            SlamSystem(dataclasses.replace(SystemConfig(), sensor=sensor),
                       device="cpu")
