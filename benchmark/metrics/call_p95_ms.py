"""The 95th percentile of every window call's latency, from its start to
its return (Python's `statistics.quantiles`, 20 parts, inclusive)."""

import statistics


def read(ctx):
    lat = [(r.end - r.start) * 1e3 for r in ctx.records]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
