"""A pipelined run of both packages (``pipeline_depth`` 8) with the scene
graph on, the reference in its own float32 numerics and both on the
reference's pyramid: the same trajectory within 0.01 m, the same
keyframes, serial reliefs and batch re-tracks."""

import jax
import numpy as np
import pytest
import torch

from visual_sgraphs_tpu_torch.core import geometry as pgeo
from visual_sgraphs_tpu_torch.features import pyramid as ppyr

import torch_parity as tp
from torch_parity import ReferenceHypotheses
from torch_parity import one_torch_thread  # noqa: F401
from torch_pipeline_harness import (
    ATE_GATE,
    N_RUN,
    POS_TOL,
    bench_harness_config,
    events,
    harness_frames,
    keyframes,
    port_run,
    reference_resize,
    reference_run,
)

B = 8


@pytest.fixture(scope="module")
def pipelined_runs():
    # Both runs in the reference's own float32 numerics (this suite's
    # conftest turns on float64, which the library never runs in), and the
    # port on the reference's resize in place of its twin: XLA's CPU matrix
    # product inside jax.image.resize adds a pair of taps' products before
    # the third, where the twin (the kernel's rounding) fuses one
    # multiply-add a tap. The levels then differ by 2-3 ulp on [0, 255]
    # (the twin is held within 1e-4 by test_torch_features.py), a FAST score
    # at a near-tie flips on most of these frames, and the two runs part by
    # ~0.15 m by frame 50; on the same pyramid they stay within 0.004 m.
    frames = harness_frames(192)[:N_RUN]
    with jax.enable_x64(False), pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppyr, "resize_bilinear_torch", reference_resize)
        ref = tp.cached(f"pipelined_reference_f32_{N_RUN}", reference_run)
        port = port_run(bench_harness_config(8, False), frames,
                        ReferenceHypotheses())
    return ref, port


def test_pipelined_run_matches_reference(pipelined_runs):
    ref, port = pipelined_runs
    assert port.cfg.tracking.pipeline_depth == B
    assert len(port.trajectory) == ref["n_traj"] == N_RUN
    np.testing.assert_array_equal(port.tracked_mask(), ref["tracked"])
    n = port.n_serial
    assert n >= 8 and (N_RUN - n) // B >= 4  # a scan and three cycles ran
    pos = port.positions()
    np.testing.assert_allclose(pos, ref["pos"], rtol=0, atol=POS_TOL)
    gt = np.stack([T[4:7] for _, _, _, T, _ in harness_frames(192)[:N_RUN]])
    ates = [float(pgeo.ate_rmse(torch.from_numpy(p), torch.from_numpy(gt))[0])
            for p in (pos, ref["pos"])]
    assert max(ates) <= ATE_GATE, ates
    # the same keyframes, in the same slots, chosen at the same counts
    assert int(port.map.n_kf) == ref["n_kf"]
    assert keyframes(port) == ref["keyframes"]
    assert events(port) == ref["events"]
    # the batched path ran: one readback a batch, far under one a frame
    # after the ramp-in
    assert port.host_readbacks < N_RUN
