"""Port parity of the synthetic RGB-D renderer (used by the port's own
smoke run, which has no JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu.io import synthetic as rsyn
from visual_sgraphs_tpu_torch.io import synthetic as psyn

from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("kind", ["arc", "orbit2"])
def test_render_matches(kind):
    # depth within 1e-5 relative and semantics exact (one ray/plane
    # intersection in float32); gray equal on >= 99% of pixels: the
    # texture hash sin(x)*43758 amplifies last-bit differences of the hit
    # point at cell edges
    ref = rsyn.SyntheticScene(h=120, w=160)
    port = psyn.SyntheticScene(h=120, w=160, device="cpu")
    traj = ref.trajectory(9, kind)
    np.testing.assert_allclose(port.trajectory(9, kind), traj, rtol=0,
                               atol=1e-5)
    for T in traj[::4]:
        rg, rd, rs = (np.asarray(x) for x in rsyn.render(
            jnp.asarray(T), ref.planes, ref.cam_K, 120, 160))
        pg, pd, ps = (x.numpy() for x in port.render(T))
        np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(ps, rs)
        assert np.mean(np.abs(pg - rg) < 1e-3) >= 0.99


def test_scene_camera_matches():
    r = rsyn.SyntheticScene(h=480, w=640).cam
    p = psyn.SyntheticScene(h=480, w=640, device="cpu").cam
    assert (r.fx, r.fy, r.cx, r.cy, r.width, r.height, r.bf) == \
        (p.fx, p.fy, p.cx, p.cy, p.width, p.height, p.bf)


def test_room_planes_match():
    r = rsyn.room_planes(half_x=12.0, half_y=2.0, z_back=16.0, z_front=-4.0)
    p = psyn.room_planes(half_x=12.0, half_y=2.0, z_back=16.0, z_front=-4.0)
    np.testing.assert_array_equal(p.coeffs.numpy(), np.asarray(r.coeffs))
    np.testing.assert_array_equal(p.semantic.numpy(), np.asarray(r.semantic))
    # the texture as the reference renders it (jitted: XLA contracts its
    # multiply-adds, which the port reproduces); exact on >= 99% of points
    pts = (np.random.default_rng(0).normal(size=(4096, 3)) * 3).astype(
        np.float32)
    ref_tex = np.asarray(jax.jit(rsyn.cell_texture)(jnp.asarray(pts)))
    port_tex = psyn.cell_texture(torch.from_numpy(pts)).numpy()
    assert np.mean(port_tex == ref_tex) >= 0.99


def test_frames_with_semantics_match():
    # class images exact, depth within 1e-5 relative, poses and stamps
    # equal
    ref = rsyn.SyntheticScene(h=120, w=160)
    port = psyn.SyntheticScene(h=120, w=160, device="cpu")
    for (_, rd, rs, rT, rts), (_, pd, ps, pT, pts) in zip(
            ref.frames_with_semantics(5, "orbit2"),
            port.frames_with_semantics(5, "orbit2")):
        np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
        np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(pT, np.asarray(rT), rtol=0, atol=1e-5)
        assert pts == rts


def test_entry_points_default_to_the_card():
    # SlamSystem, SyntheticScene and SceneGraphManager run on the card
    # unless asked for the CPU, and raise (never fall back) without one
    from visual_sgraphs_tpu_torch.config import SystemConfig
    from visual_sgraphs_tpu_torch.scenegraph import SceneGraphManager
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem

    makers = (lambda: psyn.SyntheticScene(h=24, w=32),
              lambda: SceneGraphManager(),
              lambda: SlamSystem(SystemConfig()))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()
