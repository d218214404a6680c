"""The program's own spans, for the metrics that read them.

`nicetpu_torch.utils.profiling` records a span where the program names a
stretch of its host work, while a `torch.profiler` session records.  In a
traced run those are the profiled calls after the window (they start after
`ctx.t1`).  A metric's milliseconds are a profiled call's, over
`ctx.trace.calls`: comparable between two programs, not with the rate of an
untraced run.  A program that records no spans gives None.
"""

from __future__ import annotations


def report(ctx):
    """`profiling.spans` of the profiled calls, or None where there are none."""
    if ctx.trace is None or not ctx.trace.calls:
        return None
    try:
        from nicetpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = spans(since=ctx.t1)
    return got if got.spans else None


def ms_per_call(ctx, names) -> float | None:
    """The summed duration of the spans of these names, ms a profiled call;
    None where none of them ran."""
    got = report(ctx)
    if got is None or not any(n in got.total_ms for n in names):
        return None
    return sum(got.total_ms.get(n, 0.0) for n in names) / ctx.trace.calls
