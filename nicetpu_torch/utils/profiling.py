"""Stage timing and the port's spans.

`StageTimer` (the port's copy of `nicetpu.utils.profiling.StageTimer`) is a
structured stage timer on the host's wall clock: named stages, their
milliseconds, the total and the MB/s derived from a byte count.
`MarkedStageTimer` drives the same timer by marks and waits for the device
at each, for the per-rank stages of the sharded codec.

`mark_stage` and `span` time the single-device paths.  A caller that passes
a `marks=` list receives (stage, CUDA event) pairs, one where each stage
ends.  A span names a stretch of the program's host work:

    with span("decode3.device_groups"):
        ...

Spans are off unless a `torch.profiler` session is recording in the thread,
or an operator opens `recording()`; off, `span` records nothing and returns
one shared null context.  On, a span opens a host range named
"nt:<layer>.<stage>" in the profiler's trace (an ordinary range, kept off
the device timeline, unlike `torch.profiler.record_function`'s user
annotations) and keeps its name, host start and end (`time.perf_counter`),
its parent span and its call in a bounded store, read by `spans(since)`.
The outermost span a thread opens starts a new call; the spans inside it
share its call id.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

PREFIX = "nt:"  # of a span's range in a profiler trace
MAX_SPANS = 1 << 16  # spans the store keeps; the oldest go first


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


def mark_stage(marks, name: str) -> None:
    """Append (name, CUDA event recorded now on the current stream) to
    `marks` when it is a list; do nothing when it is None."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


class Span(NamedTuple):
    """One recorded span; times in `time.perf_counter` seconds."""

    name: str
    start: float
    end: float
    id: int
    parent: int | None  # the enclosing span's id; None for a call's outermost span
    call: int  # shared by the spans of one outermost span
    thread: int
    self_ms: float  # the duration less the part its child spans cover


class Report(NamedTuple):
    """What `spans(since)` reads."""

    spans: list[Span]  # in order of their start
    total_ms: dict[str, float]  # name -> summed duration


_store: deque = deque(maxlen=MAX_SPANS)  # (name, start, end, id, parent, call, thread)
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans, innermost last
_ids = itertools.count(1)
_calls = itertools.count(1)
_recording = 0  # open `recording()` contexts, in any thread
_OFF = contextlib.nullcontext()


def _stage(name: str) -> str:
    """The mark of a span "<layer>.<stage>": its stage."""
    return name.split(".", 1)[-1]


class _Marked:
    """An off span with a `marks` list: marks the stage's end, as
    `mark_stage` does."""

    __slots__ = ("name", "marks")

    def __init__(self, name: str, marks: list) -> None:
        self.name, self.marks = name, marks

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            mark_stage(self.marks, _stage(self.name))
        return False


class _Span:
    __slots__ = ("name", "marks", "range", "start", "id", "parent", "call")

    def __init__(self, name: str, marks) -> None:
        self.name, self.marks = name, marks

    def __enter__(self) -> None:
        stack = _local.__dict__.setdefault("stack", [])
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.call = next(_calls) if outer is None else outer.call
        stack.append(self)
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.start = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter()
        self.range.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        if exc_type is None:
            mark_stage(self.marks, _stage(self.name))
        row = (self.name, self.start, end, self.id, self.parent, self.call, threading.get_ident())
        with _lock:
            _store.append(row)
        return False


def span(name: str, marks=None):
    """A context manager over one stretch of host work, named
    "<layer>.<stage>".  On exit it appends the stage's mark to `marks`
    where that is a list (see `mark_stage`), whether spans are on or off.
    Spans are on while a `torch.profiler` session records in this thread or
    a `recording()` is open."""
    if _recording or _profiler_enabled():
        return _Span(name, marks)
    return _OFF if marks is None else _Marked(name, marks)


@contextlib.contextmanager
def recording():
    """Record spans in every thread while open, without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(since: float = 0.0) -> Report:
    """The spans that started at `time.perf_counter()` time `since` or
    later, each with its self time, and the total ms of each name."""
    with _lock:
        rows = sorted((r for r in _store if r[1] >= since), key=lambda r: r[1])
    covered: dict = {}
    total: dict = {}
    for name, start, end, _, parent, _, _ in rows:
        covered[parent] = covered.get(parent, 0.0) + end - start
        total[name] = total.get(name, 0.0) + 1e3 * (end - start)
    out = [Span(*r, self_ms=1e3 * (r[2] - r[1] - covered.get(r[3], 0.0))) for r in rows]
    return Report(out, total)
