"""Port parity of K18 with the pose prediction: ``preint_frame``'s plain
version (the frame window, its merge into a packed keyframe window and
``predict_state`` from the frame window) against the reference's
``_preintegrate_window`` + ``merge`` + ``predict_state``, jitted, in
float32, on seeded numpy inputs: 7 valid rows, padding in mid-table, all
64 rows valid, with zero and non-zero biases; and the ``ImuPipeline``
path that carries the prediction from ``preintegrate_frame`` to
``predict``.

Tolerances: ΔR, ΔV, ΔP and the bias Jacobians within PREINT_TOL (1e-5) of
each field's largest entry, the covariances within PREINT_COV_TOL (1e-4),
the integration times exactly (float32 sums in sample order), the
predicted pose components (quaternion and translation) and velocity
within 1e-5 absolute (the same float32 operations summed in another
order, on poses of unit scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.config import ImuConfig as RefImuConfig
from visual_sgraphs_tpu.core import lie as rlie
from visual_sgraphs_tpu.inertial import pipeline as rpipe
from visual_sgraphs_tpu.inertial import preintegration as rpre
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.config import ImuConfig
from visual_sgraphs_tpu_torch.inertial import pipeline as ppipe
from visual_sgraphs_tpu_torch.inertial import preintegration as ppre
from visual_sgraphs_tpu_torch.selfcheck import PREINT_COV_TOL, PREINT_TOL

import torch_parity as tp
from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
PRED_TOL = 1e-5
NG, NA = 1.7e-4, 2.0e-3


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _table(rng, valid):
    """A (64, 8) sample table at 200 Hz with ``valid`` rows."""
    T = len(valid)
    om = (rng.normal(size=(T, 3)) * 0.6).astype(np.float32)
    ac = (rng.normal(size=(T, 3)) * 2 + [0, 9.8, 0]).astype(np.float32)
    dts = np.where(valid, np.float32(0.005), np.float32(0.0))
    return om, ac, dts.astype(np.float32), np.asarray(valid)


def _rows(kind: str) -> np.ndarray:
    v = np.zeros(64, bool)
    if kind == "seven":
        v[:7] = True
    elif kind == "mid_pad":
        v[[0, 1, 2, 4, 5, 9, 10, 11, 30]] = True  # padding between samples
    else:
        v[:] = True
    return v


@jax.jit
def _ref_frame(since, om, ac, dts, valid, bg, ba, T_cw, v, T_bc):
    win = rpipe._preintegrate_window(om, ac, dts, valid, bg, ba, NG, NA)
    T_j, v_j = rpipe.predict_state(T_cw, v, win, T_bc)
    return win, rpre.merge(since, win), T_j, v_j


def _case(kind: str, biased: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    bg = (rng.normal(size=3) * 0.01 * biased).astype(np.float32)
    ba = (rng.normal(size=3) * 0.05 * biased).astype(np.float32)
    # a keyframe window of two earlier frames
    since = rpre.identity_preint(jnp.asarray(bg), jnp.asarray(ba))
    for _ in range(2):
        w = rpipe._preintegrate_window(
            *map(jnp.asarray, _table(rng, _rows("seven"))), jnp.asarray(bg),
            jnp.asarray(ba), NG, NA)
        since = rpre.merge(since, w)
    xi = (rng.normal(size=(2, 6)) * 0.4).astype(np.float32)
    T_cw, T_bc = (np.asarray(rlie.se3_exp(jnp.asarray(x)), np.float32)
                  for x in xi)
    vel = (rng.normal(size=3) * 0.5).astype(np.float32)
    return dict(since=since, tab=_table(rng, _rows(kind)), bg=bg, ba=ba,
                T_cw=T_cw, v=vel, T_bc=T_bc)


def _assert_preint_close(p, r):
    for f in FIELDS:
        assert _rel_err(getattr(p, f).numpy(), getattr(r, f)) <= PREINT_TOL, f
    assert _rel_err(p.cov.numpy(), r.cov) <= PREINT_COV_TOL
    assert p.dt.numpy() == np.asarray(r.dt)
    np.testing.assert_array_equal(p.bias_g.numpy(), np.asarray(r.bias_g))
    np.testing.assert_array_equal(p.bias_a.numpy(), np.asarray(r.bias_a))


@pytest.mark.parametrize("kind", ["seven", "mid_pad", "all64"])
@pytest.mark.parametrize("biased", [True, False], ids=["bias", "no_bias"])
def test_preint_frame_twin_matches_reference(kind, biased):
    c = _case(kind, biased)
    with jax.enable_x64(False):
        r_win, r_merged, r_T, r_v = _ref_frame(
            c["since"], *map(jnp.asarray, c["tab"]), jnp.asarray(c["bg"]),
            jnp.asarray(c["ba"]), jnp.asarray(c["T_cw"]),
            jnp.asarray(c["v"]), jnp.asarray(c["T_bc"]))
    since = interop.preint_from_numpy(tp.to_np(c["since"]))
    tab = ppre.sample_table(*(torch.from_numpy(np.asarray(x))
                              for x in c["tab"]))
    win, merged, pred = ppre.preint_frame(
        ppre.pack(since), tab, torch.from_numpy(c["bg"]),
        torch.from_numpy(c["ba"]), NG, NA,
        pose=tuple(torch.from_numpy(c[k]) for k in ("T_cw", "v", "T_bc")))
    _assert_preint_close(ppre.unpack(win), r_win)
    _assert_preint_close(ppre.unpack(merged), r_merged)
    np.testing.assert_allclose(pred[0].numpy(), np.asarray(r_T), rtol=0,
                               atol=PRED_TOL)
    np.testing.assert_allclose(pred[1].numpy(), np.asarray(r_v), rtol=0,
                               atol=PRED_TOL)
    # without the pose: the same windows and no prediction
    win2, merged2, none = ppre.preint_frame(
        ppre.pack(since), tab, torch.from_numpy(c["bg"]),
        torch.from_numpy(c["ba"]), NG, NA)
    assert none is None
    assert torch.equal(win2, win) and torch.equal(merged2, merged)


def test_pack_of_unpacked_views_is_the_vector():
    # the packed vector K18 writes: unpack gives views of it, pack gives
    # its values back in a new vector
    vec = torch.arange(ppre.PACKED, dtype=torch.float32)
    views = ppre.unpack(vec)
    base = vec.untyped_storage().data_ptr()
    assert all(f.untyped_storage().data_ptr() == base for f in views)
    back = ppre.pack(views)
    assert torch.equal(back, vec) and back.data_ptr() != vec.data_ptr()


def test_pipeline_prediction_from_preintegrate_frame():
    # ImuPipeline on the CPU: once initialised, preintegrate_frame given
    # the last pose carries the prediction that predict returns (the
    # reference's predict_state on the frame window), keeps vel_prev, and
    # leaves the keyframe window and the host dt mirrors as the reference
    rng = np.random.default_rng(5)
    pp = ppipe.ImuPipeline(ImuConfig(), 8, device="cpu")
    rp = rpipe.ImuPipeline(RefImuConfig(), 8)
    T_cw = np.asarray(rlie.se3_exp(jnp.asarray(
        (rng.normal(size=6) * 0.3).astype(np.float32))), np.float32)
    vel = np.float32([0.2, -0.1, 0.3])
    pp.initialized = True
    pp.vel = torch.from_numpy(vel)
    t = 0.0
    for k in range(3):
        ts = (t + 0.005 * np.arange(1, 8)).tolist()
        om = (rng.normal(size=(7, 3)) * 0.5).astype(np.float32)
        ac = (rng.normal(size=(7, 3)) + [0, 9.8, 0]).astype(np.float32)
        pp.add_samples(om, ac, ts)
        rp.add_samples(om, ac, ts)
        t = ts[-1]
        T_last = torch.from_numpy(T_cw)
        p_pre = pp.preintegrate_frame(t, T_last)
        with jax.enable_x64(False):
            r_pre = rp.preintegrate_frame(t)
            r_T, r_v = rpipe.predict_state(jnp.asarray(T_cw),
                                           jnp.asarray(vel), r_pre,
                                           jnp.asarray(RefImuConfig().T_bc,
                                                       jnp.float32))
        v_before = pp.vel
        T_pred = pp.predict(T_last, p_pre)
        assert pp.vel_prev is v_before
        np.testing.assert_allclose(T_pred.numpy(), np.asarray(r_T), rtol=0,
                                   atol=PRED_TOL)
        np.testing.assert_allclose(pp.vel.numpy(), np.asarray(r_v), rtol=0,
                                   atol=PRED_TOL)
        assert np.float32(pp._since_kf_dt) == np.asarray(rp._since_kf.dt)
        assert pp.frame_dt == float(p_pre.dt)
        T_cw, vel = T_pred.numpy(), pp.vel.numpy()
    assert pp.windows == 3
    # the frame window it returns is views of the vector K20 takes
    assert torch.equal(ppre.pack(p_pre), pp.frame_vec)
    assert (p_pre.dR.untyped_storage().data_ptr()
            == pp.frame_vec.untyped_storage().data_ptr())
    # initialised: the last pose is needed, and a prediction is only
    # returned for the pose it was made from
    ts = (t + 0.005 * np.arange(1, 8)).tolist()
    pp.add_samples(om, ac, ts)
    with pytest.raises(ValueError):
        pp.preintegrate_frame(ts[-1])
    p_pre = pp.preintegrate_frame(ts[-1], torch.from_numpy(T_cw))
    with pytest.raises(ValueError):
        pp.predict(torch.from_numpy(T_cw), p_pre)
    assert pp.predict(torch.from_numpy(T_cw), None) is None
