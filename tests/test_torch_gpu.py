"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips (inside the fixture, never at import) when
``torch.cuda.is_available()`` is false, as on the CPU-only test machine.
``python3 chip_smoke.py`` runs the same comparisons on the card.
"""

import numpy as np
import pytest
import torch

from visual_sgraphs_tpu_torch import cuda, selfcheck


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    cuda.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def slice_levels(device):
    return selfcheck.slice_levels(device)


@pytest.mark.gpu
def test_fast_nms_kernel(slice_levels):
    r = selfcheck.check_fast_nms(slice_levels[0])
    assert r["ok"], r


@pytest.mark.gpu
def test_orb_desc_kernel(slice_levels):
    _, rcs, blurred = slice_levels
    r = selfcheck.check_orb_desc(rcs, blurred)
    assert r["ok"], r


@pytest.mark.gpu
def test_match_window_kernel(device):
    r = selfcheck.check_match_window(device)
    assert r["ok"] and r["n_matched"] > 500, r


@pytest.mark.gpu
def test_pose_gn_kernel(device):
    r = selfcheck.check_pose_gn(device)
    assert r["ok"], r


@pytest.mark.gpu
def test_slice_on_card_uses_every_kernel(device):
    from visual_sgraphs_tpu_torch.config import (
        CapacityConfig, MappingConfig, OrbConfig, SystemConfig)
    from visual_sgraphs_tpu_torch.io.synthetic import SyntheticScene
    from visual_sgraphs_tpu_torch.slam.system import SlamSystem

    scene = SyntheticScene(h=240, w=320, device=device)
    cfg = SystemConfig(camera=scene.cam, orb=OrbConfig(n_features=300),
                       capacity=CapacityConfig(32, 4096),
                       mapping=MappingConfig(lba_iters=6, lba_interval=2,
                                             cull_interval=2))
    cuda.reset_counts()
    system = SlamSystem(cfg, device=device)
    gt = []
    for g, d, T, ts in scene.frames(12, kind="arc"):
        system.track_rgbd(g, d, ts)
        gt.append(T[4:7])
    pos = system.positions()
    counts = cuda.counts()
    assert all(launches > 0 and twin == 0
               for launches, twin in counts.values()), counts
    assert np.isfinite(pos).all() and system.tracked_mask().all()
    err = np.linalg.norm(pos - pos[0] - (np.stack(gt) - gt[0]), axis=1)
    assert err.max() < 0.1
