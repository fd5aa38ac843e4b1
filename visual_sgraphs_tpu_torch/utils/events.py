"""Structured event log (port of ``visual_sgraphs_tpu/utils/events.py``).

Every lifecycle event is one record (wall_time, kind, payload) that the
host can filter and count.
"""

from __future__ import annotations

import time


class EventLog:
    """Append-only in-memory event records: (wall_time, kind, payload)."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.records: list[tuple[float, str, dict]] = []

    def emit(self, kind: str, **payload) -> None:
        self.records.append((time.time(), kind, payload))
        if self.verbose:
            print(f"[{kind}] {payload}")

    def count(self, kind: str) -> int:
        return sum(1 for _, k, _ in self.records if k == kind)

    def of_kind(self, kind: str) -> list[dict]:
        return [p for _, k, p in self.records if k == kind]

