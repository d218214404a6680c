"""Reading a `torch.profiler` trace: device busy time, idle gaps named by
what the host was doing, and the device operations that took the most time.

The interval arithmetic (`union`) is the program's `bench_trace.union_ms`,
copied so that the yardstick does not move with the program.  Times are the
profiler's microseconds.
"""

from __future__ import annotations

import heapq

SPAN = "bench:"  # prefix of the benchmark's own record_function spans
WINDOW = SPAN + "traced_window"
NAME_CHARS = 120
TOP = 10


def union(intervals, lo: float, hi: float) -> float:
    """Total length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        a = max(a, reach)
        if b > a:
            total += b - a
            reach = b
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The sub-intervals of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        out.append((reach, hi))
    return out


def top(rows, n: int = TOP) -> list[list]:
    """rows of (name, seconds): the n names of the largest total, as
    [name, seconds] pairs."""
    agg: dict = {}
    for name, s in rows:
        agg[name] = agg.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:n]]


def host_names(points, host_events) -> list[str]:
    """For each time in `points` (sorted), what the host was doing: the
    innermost benchmark span and the innermost other host event that cover
    it ("python" where none does).  host_events: (name, start, end)."""
    evs = sorted(host_events, key=lambda e: e[1])
    active: list = []  # heap of (end, start, name)
    out, k = [], 0
    for t in points:
        while k < len(evs) and evs[k][1] <= t:
            heapq.heappush(active, (evs[k][2], evs[k][1], evs[k][0]))
            k += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        spans = [(s, n) for _, s, n in active if n.startswith(SPAN) and n != WINDOW]
        ops = [(s, n) for _, s, n in active if not n.startswith(SPAN)]
        span = max(spans)[1][len(SPAN):] if spans else "harness"
        op = max(ops)[1] if ops else "python"
        out.append(f"{span} / {op}"[:NAME_CHARS])
    return out


class Summary:
    """What the metrics read from one profiled segment of the window."""

    def __init__(self, device_ops, host_events, lo: float, hi: float, calls: int, work_bytes: int):
        self.device_ops = device_ops  # (name, start, end)
        self.lo, self.hi = lo, hi
        self.calls, self.work_bytes = calls, work_bytes
        spans = [(a, b) for _, a, b in device_ops]
        self.busy_s = union(spans, lo, hi) / 1e6
        self.window_s = (hi - lo) / 1e6
        idle = gaps(spans, lo, hi)
        names = host_names([(a + b) / 2 for a, b in idle], host_events)
        self.idle_gaps = top((n, (b - a) / 1e6) for n, (a, b) in zip(names, idle))
        self.top_ops = top((n[:NAME_CHARS], (b - a) / 1e6) for n, a, b in device_ops)


def summarize(prof, calls: int, work_bytes: int) -> Summary:
    """A Summary of a profiler session whose calls ran inside WINDOW."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = next(e for e in events if e.name == WINDOW and e.device_type != DeviceType.CUDA)
    lo, hi = win.time_range.start, win.time_range.end
    device, host = [], []
    for e in events:
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN):  # spans are mirrored on the device as annotations
                device.append(row)
        elif e.name != WINDOW:
            host.append(row)
    return Summary(device, host, lo, hi, calls, work_bytes)
