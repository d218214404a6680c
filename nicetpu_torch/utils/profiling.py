"""Stage timing (the port's copy of `nicetpu.utils.profiling.StageTimer`).

A structured stage timer on the host's wall clock: named stages, their
milliseconds, the total and the MB/s derived from a byte count.
`MarkedStageTimer` drives the same timer by marks and waits for the device
at each, for the per-rank stages of the sharded codec.  Device stages are
timed with CUDA events by the callers that need them
(`kernels.encode2.mark_stage`).
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


class StageTimer:
    """Collects named stage durations; prints a one-line JSON summary."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def summary(self, nbytes: int | None = None) -> str:
        out: dict = {k: round(v * 1e3, 2) for k, v in self.stages.items()}
        total = sum(self.stages.values())
        out["total_ms"] = round(total * 1e3, 2)
        if nbytes and total > 0:
            out["MB/s"] = round(nbytes / 1e6 / total, 2)
        return json.dumps(out)


class MarkedStageTimer(StageTimer):
    """A StageTimer driven by marks: mark(name) adds the seconds since the
    previous mark to stage `name`.  Each mark first waits for `device`, so
    that a stage holds its own device work.  The stages are kept in
    stats["stages"]; with stats None, marking does nothing."""

    def __init__(self, stats: dict | None, device) -> None:
        super().__init__()
        self.on = stats is not None
        if self.on:
            self.stages = stats.setdefault("stages", {})
        self.device = device
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + now - self.t
        self.t = now
