"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up: the corpus pixels (pinned, cached in
`benchmark/.cache/`), the cell's pool of images drawn from the seed, the
call's inputs (the reference's bytes, for a decode), the program and one
warm-up pass.  Then a closed loop with one client calls the program for
`--seconds` seconds, each call issued when the one before returns, over the
pool in turn; the window ends when the last call returns.  With `--trace 1`
the same loop runs through the call's traced entry, with stage marks, and
`torch.profiler` records calls after it.  Each pool image's first call and
a seeded share of the others are watched: the harness keeps a digest of
their answers (and a round trip's call module judges the pixels its device
decoded), and after the window the reference judges them.  The host's load
and the card's clocks are read at the window's start and end.  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and `checks` last: each number
compared with its limit, which also end standard error.

Exits non-zero without printing a result when CUDA is absent or has fewer
cards than the cell asks for, or when `jax`, `jaxlib`, `flax` or `nicetpu`
(top-level module names, compared whole) were loaded by the time the
window closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import torch  # noqa: E402

from benchmark import corpus, trace  # noqa: E402
from benchmark.spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nicetpu")
SAMPLE_SHARE = 0.1  # of the calls after each pool image's first, watched for the check
CARD_FIELDS = ("power.limit", "power.draw", "clocks.sm", "clocks.mem", "temperature.gpu",
               "clocks_throttle_reasons.active")


def steady_heap() -> bool:
    """Keep freed memory in this process's heap (glibc's `mallopt`: blocks
    under 32 MB from the heap, which is never trimmed), so that the arrays
    of a call, a few MB each, reuse pages already mapped instead of mapping
    and faulting fresh ones every call, as a long-running batch process
    settles into.  Left alone, glibc's threshold moves with the order of
    frees, and a host-bound run holds one of two speeds for its window.
    False where the C library has no `mallopt`."""
    try:
        libc = ctypes.CDLL("libc.so.6")
        return libc.mallopt(-3, 32 << 20) == 1 and libc.mallopt(-1, (1 << 31) - 1) == 1
    except (OSError, AttributeError):  # M_MMAP_THRESHOLD, M_TRIM_THRESHOLD above
        return False


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Record:
    """One call of the window."""

    items: list[int]
    start: float
    end: float
    raw_bytes: int
    work_bytes: int
    digests: list | None = None  # what the check keeps of a watched call's answers
    error: str | None = None
    marks: list | None = None


@dataclass
class Ctx:
    """What a metric's `read(ctx)` may read."""

    device: torch.device
    setup_s: float = 0.0
    records: list[Record] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    peak_bytes: int = 0  # the program's: less what the check itself holds on the device
    stats: dict = field(default_factory=dict)
    stage_ms: dict = field(default_factory=dict)  # stage -> ms summed over the window's calls
    trace: trace.Summary | None = None
    card: str = ""
    peaks: dict = field(default_factory=dict)

    @property
    def calls(self) -> int:
        return len(self.records)

    @property
    def images(self) -> int:
        return sum(len(r.items) for r in self.records)


def _span(fn, name):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def install_spans(call) -> None:
    """Wrap each (module, attribute) of the call's SPANS in a span of the
    benchmark's own; one the program no longer has is skipped, with a note."""
    for modname, attr in getattr(call, "SPANS", ()):
        mod = importlib.import_module(modname)
        fn = getattr(mod, attr, None)
        if fn is None:
            print(f"note: no {modname}.{attr} to span", file=sys.stderr)
            continue
        setattr(mod, attr, _span(fn, f"{trace.SPAN}{modname.rsplit('.', 1)[-1]}.{attr}"))


def stage_ms(records: list[Record]) -> dict:
    """Stage -> ms summed over the calls: a stage's time runs from the mark
    before it to its own, summed over marks of one name within a call."""
    out: dict = {}
    for r in records:
        for (_, a), (name, b) in zip(r.marks or [], (r.marks or [])[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def card_state(device: torch.device) -> dict:
    """The card's power limit and draw (W), clocks (MHz), temperature (C)
    and active clock-limit reasons, as nvidia-smi reads them now."""
    if device.type != "cuda":
        return {}
    try:
        line = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(CARD_FIELDS)}",
                               "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": type(e).__name__}
    values = [v.strip() for v in line.split(",")]
    return dict(zip(CARD_FIELDS, values)) if len(values) == len(CARD_FIELDS) else {"error": line[:200]}


def host_times() -> tuple[int, int, float, float]:
    """(all CPUs' jiffies, their idle and iowait jiffies, this process's CPU
    seconds, wall seconds): the host's load over an interval is the
    difference.  The jiffies read 0 where /proc/stat cannot be read."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        total, idle = sum(v[:8]), v[3] + v[4]
    except (OSError, ValueError, IndexError):
        total = idle = 0
    return total, idle, time.process_time(), time.perf_counter()


def host_load(a: tuple, b: tuple) -> dict:
    """Cores busy on the whole host and in this process between two
    `host_times` readings, and the load averages now."""
    cores = os.cpu_count() or 1
    dt, wall = b[0] - a[0], b[3] - a[3]
    return {"cores": cores, "busy_cores": cores * (dt - (b[1] - a[1])) / dt if dt > 0 else None,
            "process_cores": (b[2] - a[2]) / wall if wall > 0 else None,
            "loadavg": list(os.getloadavg())}


def run_cell(spec: Spec, name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", started: float | None = None, make_program=None,
             max_calls: int | None = None) -> dict:
    """One run of a cell; returns the result object.  `device="cpu"` runs
    the program's plain versions (for tests: no device metric reads a
    number then).  make_program(call, pool, inputs, device), where given,
    builds what stands in for the system under test (the control, or a
    program with a fault planted for a test); max_calls, where given, also
    ends the window after that many calls."""
    started = time.time() if started is None else started
    cell = spec.cell(name)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    call = spec.module("calls", traffic["call"])
    content = spec.module("content", config["content"]["kind"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    pixels = corpus.load(spec.root, content.corpus_names(config["content"]))
    pool = content.make(config, seed, pixels)
    del pixels
    inputs = call.prepare(pool, spec.root)
    program = (make_program or (lambda c, p, i, d: c.Program(d, p)))(call, pool, inputs, dev)
    watch = getattr(program, "watch", lambda items: None)
    per_call = config["per_call"]

    def items(i: int) -> list[int]:
        return [(i * per_call + j) % len(pool) for j in range(per_call)]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if traced:
        install_spans(call)
    for i in range(config["warmup_calls"]):
        batch = [inputs[k] for k in items(i)]
        program.call(batch, {})
        if traced:
            program.traced(batch, {}, [] if cuda else None)
    sync()

    keep = random.Random(f"{seed}/sample")

    def one_call(i: int, stats: dict, marked: bool, span: str | None = None) -> Record:
        its = items(i)
        batch = [inputs[k] for k in its]
        # every pool image once, then a seeded share of the calls; never a profiled call
        watched = span is None and (i * per_call < len(pool) or keep.random() < SAMPLE_SHARE)
        watch(its if watched else None)
        marks = None
        if marked and cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks = [("call_start", ev)]
        out = err = None
        a = time.perf_counter()
        try:
            if span:
                from torch.profiler import record_function

                with record_function(span):
                    out = program.traced(batch, stats, marks)
            else:
                out = program.traced(batch, stats, marks) if traced else program.call(batch, stats)
        except Exception as e:  # a failed call is counted, and the run is not correct
            err = f"{type(e).__name__}: {e}"
        b = time.perf_counter()
        watch(None)
        work = sum(call.work_bytes(pool[k], inputs[k], o) for k, o in zip(its, out)) if out else 0
        digests = [call.digest(o) for o in out] if watched and out is not None else None
        return Record(its, a, b, sum(call.raw_bytes(pool[k]) for k in its), work,
                      digests, err, marks)

    ctx = Ctx(device=dev)
    card_start = card_state(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.setup_s = time.time() - started
    times0 = host_times()
    ctx.t0 = time.perf_counter()
    i = 0
    while not ctx.records or (ctx.records[-1].end - ctx.t0 < seconds
                              and len(ctx.records) != max_calls):
        ctx.records.append(one_call(i, ctx.stats, traced))
        i += 1
    ctx.t1 = ctx.records[-1].end
    load = host_load(times0, host_times())
    card_end = card_state(dev)
    sync()
    peak_raw = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    ctx.peak_bytes = peak_raw - int(getattr(program, "resident_bytes", 0))
    profiled: list[Record] = []
    if traced:
        # the marks' stages come from the window; the device trace from
        # calls after it, under the profiler, each in a span of its own
        from torch.profiler import ProfilerActivity, profile, record_function

        ctx.stage_ms = stage_ms(ctx.records) if cuda else {}
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        with record_function(trace.WINDOW):
            for _ in range(config["trace_calls"]):
                profiled.append(one_call(i, {}, False, span=f"{trace.SPAN}{traffic['call']}"))
                i += 1
            sync()
        prof.stop()
        ctx.trace = trace.summarize(prof, len(profiled), sum(r.work_bytes for r in profiled))
        del prof
    for r in ctx.records:
        r.marks = None
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    with open(os.path.join(spec.folder, "peaks.json")) as f:
        ctx.peaks = json.load(f)

    # the reference judges the watched answers
    every = ctx.records + profiled
    sampled = [r for r in every if r.digests is not None]
    answers = call.expected(pool, inputs, sorted({k for r in sampled for k in r.items}), spec.root)
    wrong = checked = 0
    for r in sampled:
        checked += len(r.items)
        wrong += max(0, len(r.items) - len(r.digests))
        wrong += sum(call.wrong(d, answers[k]) for k, d in zip(r.items, r.digests))
    failed = sum(len(r.items) for r in every if r.error)
    errors = sorted({r.error for r in every if r.error})

    metrics = {}
    for m in spec.metrics(name, traced):
        value = spec.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": wrong == 0 and failed == 0 and checked > 0,
        "attempted": sum(len(r.items) for r in every),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": ctx.card,
                   "count": cell["chips"], "memory_peak_bytes": peak_raw},
    }
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.top_ops, "idle_gaps": ctx.trace.idle_gaps}
    result["card"] = {"start": card_start, "end": card_end}
    result["host"] = load
    lat = sorted((r.end - r.start) * 1e3 for r in ctx.records)
    result["window"] = {"calls": ctx.calls, "images": ctx.images, "seconds": ctx.t1 - ctx.t0,
                        "setup_s": ctx.setup_s, "latency_ms": [lat[0], lat[len(lat) // 2], lat[-1]],
                        "errors": errors[:3]}
    result["checks"] = {
        "images_wrong": {"value": wrong, "limit": 0},
        "images_failed": {"value": failed, "limit": 0},
        "images_checked": {"value": checked, "least": 1},
    }
    return result


def check_lines(result: dict) -> list[str]:
    c = result["checks"]
    return [f"images_wrong {c['images_wrong']['value']} (limit 0: a watched answer that differs from the reference, or a device proof over wrong pixels)",
            f"images_failed {c['images_failed']['value']} (limit 0: images of calls that raised)",
            f"images_checked {c['images_checked']['value']} (at least 1)"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_heap()
    spec = Spec(os.getcwd())
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", started=STARTED)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    w = result["window"]
    h, c = result["host"], result["card"]
    print(f"{w['calls']} calls, {w['images']} images in {w['seconds']:.3f} s; "
          f"card {result['device']['kind']}, at the window's start and end {c['start']} / {c['end']}; "
          f"host {h['cores']} cores, busy {h['busy_cores']}, this process {h['process_cores']}, "
          f"load average {h['loadavg']}", file=sys.stderr)
    for e in w["errors"]:
        print(f"error: {e}", file=sys.stderr)
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
