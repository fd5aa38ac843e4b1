"""``tests/test_pipeline.py::test_pipelined_partial_batch_flush`` on the
port: the B-frame pipeline with loops and the loop weld over 92 frames,
the tail through ``flush()``."""

import numpy as np
import torch

from visual_sgraphs_tpu_torch.core import geometry as pgeo

from torch_parity import one_torch_thread  # noqa: F401
from torch_pipeline_harness import bench_harness_config, harness_frames, \
    port_run


def test_pipelined_partial_batch_flush():
    # tests/test_pipeline.py::test_pipelined_partial_batch_flush on the
    # port: loops on with the loop weld (gba_after_loop=False), strict
    # slot checks, 92 of 192 frames (not a multiple of 8): the tail runs
    # through flush() and the trajectory stays frame-aligned
    frames = harness_frames(192)[:92]
    port = port_run(bench_harness_config(8, True), frames)
    assert len(port.trajectory) == 92
    gt = np.stack([T[4:7] for _, _, _, T, _ in frames])
    ate = float(pgeo.ate_rmse(torch.from_numpy(port.positions()),
                              torch.from_numpy(gt))[0])
    assert ate <= 0.2, ate
    assert port.events.count("keyframe") >= 8
