"""The PyTorch port imports without JAX and mirrors the reference config."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import visual_sgraphs_tpu.config as ref_cfg
import visual_sgraphs_tpu_torch.config as port_cfg
from visual_sgraphs_tpu_torch import interop
from visual_sgraphs_tpu_torch.interop import config_from_dict
from visual_sgraphs_tpu_torch.slam.map_state import empty_map

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import visual_sgraphs_tpu_torch as p
        names = [m.name for m in pkgutil.walk_packages(
            p.__path__, "visual_sgraphs_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = [k for k in sys.modules
               if k == "jax" or k.startswith("jax.")
               or k == "visual_sgraphs_tpu"
               or k.startswith("visual_sgraphs_tpu.")]
        assert not bad, bad
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every sub-package and module of the port imported, the scene graph
    # and the inertial layer included
    names = set(out.stdout.split())
    assert len(names) >= 45
    for mod in ("core.plane", "scenegraph.state", "scenegraph.pointcloud",
                "scenegraph.plane_fit", "scenegraph.epilogue",
                "scenegraph.manager", "scenegraph.joint_ba",
                "scenegraph.freespace", "optim.graph", "optim.factors",
                "optim.solve", "optim.lm_kernels", "place", "place.vocab", "place.database",
                "place.sim3_ransac", "place.pnp", "place.pgo",
                "place.loop_closer", "slam.cycle_program", "inertial",
                "inertial.preintegration", "inertial.factors",
                "inertial.init", "inertial.vi_ba", "inertial.pipeline"):
        assert "visual_sgraphs_tpu_torch." + mod in names, mod


_CLASSES = ("CameraConfig", "OrbConfig", "TrackingConfig", "MappingConfig",
            "CapacityConfig", "SceneGraphConfig", "PlaceConfig", "ImuConfig",
            "EnvDatabase", "SystemConfig")


@pytest.mark.parametrize("name", _CLASSES)
def test_config_fields_and_defaults_match(name):
    ref, port = getattr(ref_cfg, name), getattr(port_cfg, name)
    assert ([f.name for f in dataclasses.fields(ref)]
            == [f.name for f in dataclasses.fields(port)])
    assert dataclasses.asdict(ref()) == dataclasses.asdict(port())


def test_sensor_ids_match():
    for k in ("MONOCULAR", "STEREO", "RGBD", "IMU_MONOCULAR", "IMU_STEREO",
              "IMU_RGBD"):
        assert getattr(ref_cfg.Sensor, k) == getattr(port_cfg.Sensor, k)


def test_config_from_dict_round_trip():
    cfg = ref_cfg.SystemConfig(
        camera=ref_cfg.CameraConfig(fx=260.0, width=320, height=240),
        orb=ref_cfg.OrbConfig(n_features=300),
        capacity=ref_cfg.CapacityConfig(max_keyframes=32, max_points=4096),
        mapping=ref_cfg.MappingConfig(lba_iters=6, lba_interval=2),
        env=ref_cfg.EnvDatabase(
            rooms=(ref_cfg.EnvRoom("r", 3, door_markers=(1, 2)),),
            doors=(ref_cfg.EnvDoor("d", 1),)),
    )
    port = config_from_dict(dataclasses.asdict(cfg))
    assert isinstance(port, port_cfg.SystemConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.capacity == port_cfg.CapacityConfig(32, 4096)


def test_state_round_trip_through_numpy():
    # exact: state crosses between the packages as numpy, field for field,
    # in the port's dtypes whatever dtype the dict holds
    m = empty_map(port_cfg.CapacityConfig(4, 64), port_cfg.OrbConfig(8))
    d = interop.map_to_numpy(m)
    back = interop.map_from_numpy(d)
    for k, v in m._asdict().items():
        assert getattr(back, k).dtype == v.dtype
        np.testing.assert_array_equal(getattr(back, k).numpy(), d[k])
    rng = np.random.default_rng(0)
    frame = dict(uv=rng.normal(size=(8, 2)), depth=rng.normal(size=8),
                 level=np.arange(8, dtype=np.int64), angle=np.zeros(8),
                 desc=rng.integers(0, 256, (8, 32)), valid=np.ones(8, bool),
                 timestamp=np.float64(0.5))
    f = interop.frame_from_numpy(frame)
    assert f.desc.dtype.itemsize == 1 and f.uv.dtype.is_floating_point
    np.testing.assert_array_equal(interop.frame_to_numpy(f)["desc"],
                                  frame["desc"])
    track = dict(pose=np.eye(1, 7)[0], slot_pt=np.full(8, -1),
                 vis_pt=np.arange(16), n_matches=np.int64(3),
                 n_inliers=np.int64(2), n_local_pts=np.int64(16))
    t = interop.track_from_numpy(track)
    out = interop.track_to_numpy(t)
    for k, v in track.items():
        np.testing.assert_array_equal(out[k], v)
    with pytest.raises(KeyError):
        interop.track_from_numpy({"pose": track["pose"]})
