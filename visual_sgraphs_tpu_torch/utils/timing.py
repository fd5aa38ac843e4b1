"""Per-stage timing instrumentation — the REGISTER_TIMES equivalent.

Port of ``visual_sgraphs_tpu/utils/timing.py``: a host-side registry of
named stages.  With ``sync=True`` a stage given a CUDA tensor in
``sync_on`` waits for the device at its end, so device time is charged to
the stage that enqueued it; otherwise PyTorch's asynchronous launches
charge device time to whichever stage next reads a value back.

Off by default: no overhead on the hot path when disabled.  The slice's
stages: ``orb_extract`` (frame construction, inside the step),
``track_dispatch`` (the per-frame tracking step with its readback),
``track_resolve`` (the previous frame's deferred host decision),
``kf_insert`` (keyframe policy + program) and ``kf_program`` (insert,
fuse, cull, local BA).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimers:
    """Named wall-clock accumulators with optional device sync."""

    def __init__(self, enabled: bool = False, sync: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.max = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time a stage.  ``sync_on``: optional tensor whose device is
        synchronised at exit when ``self.sync`` (attributes device time)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if (self.sync and isinstance(sync_on, torch.Tensor)
                    and sync_on.is_cuda):
                torch.cuda.synchronize(sync_on.device)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            if dt > self.max[name]:
                self.max[name] = dt

    def summary(self) -> dict:
        """{stage: {total_s, count, mean_ms, max_ms}} for recorded stages."""
        out = {}
        for name in self.total:
            c = self.count[name]
            out[name] = {
                "total_s": self.total[name],
                "count": c,
                "mean_ms": 1e3 * self.total[name] / max(c, 1),
                "max_ms": 1e3 * self.max[name],
            }
        return out

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
        self.max.clear()
