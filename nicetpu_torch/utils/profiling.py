"""Stage timing (the port's copy of `nicetpu.utils.profiling.StageTimer`).

A structured stage timer on the host's wall clock: named stages, their
milliseconds, the total and the MB/s derived from a byte count.  Device
stages are timed with CUDA events by the callers that need them
(`kernels.encode2.mark_stage`).
"""

from __future__ import annotations

import contextlib
import json
import time


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
