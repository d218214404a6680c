"""A profiled call's untraced time in the program, ms: the self time of each
outermost program span (its duration less what its child spans cover),
summed over the profiled calls and divided by their number."""

from benchmark import spans


def read(ctx):
    got = spans.report(ctx)
    if got is None:
        return None
    return sum(s.self_ms for s in got.spans if s.parent is None) / ctx.trace.calls
