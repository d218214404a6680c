"""A persistent group of ranks that serves one raster a call: `ShardGroup`.

The caller's process is rank 0, on `cuda:0` under NCCL.  Ranks 1 ... n - 1
are processes started once (start method `spawn`), rank r on `cuda:r`, that
serve calls until the group is closed.  `torch.distributed` runs over NCCL
(gloo and the CPU for tests), initialised through
`multihost.initialize_distributed` with a loopback rendezvous and a time
limit on the rendezvous and on every collective.

A call hands the raster to rank 0 only.  Rank 0 uploads it once ("upload")
and scatters its row blocks over the group's collectives ("scatter",
`Comm.scatter_root`); no rank receives a copy of the whole raster.  The
round trip then runs the per-rank steps that the SPMD entries run too:
the sharded encode (`sharded.encode_rank`: halo, first changes, summed
histogram, device tables, pack, the ordered gather to rank 0 and the
stitch there, one kernel writing the file on card 0, counted in
"device_stitches"), the broadcast of that file tensor
(`sharded.share_bytes`), the sharded decode (`sharded_decode.decode_rank`
at the robust rung `decode3.LADDER[-1]`: walk, assembly, records
all-gather, carry pipeline), and each rank's comparison of its decoded
block with its own input block on its device; one all-reduce makes
`verified`.  This module keeps the processes, the round trip's
composition and the merge of the ranks' counters.

Host routes, each counted in stats: an overflow on any rank sends the
raster to `hostref.encode_native` ("overflow_fallbacks"); failed gates, a
shard longer than the walk holds, or a raster whose height does not split
over the ranks send it to `hostref.decode_native` and a host comparison
("fallbacks"); "host_served" counts the rasters that took either.

Failure never hangs.  A rank's exception fails the call on rank 0 with that
rank's traceback, and so does a call that outlasts `timeout`; either closes
the group, whose helpers are killed.  Helpers exit when rank 0's process
does.  `close()`, the group's garbage collection and the exit of the
caller's process each leave no process behind.

Every stage of every rank is a span "dist.<stage>" (`profiling.StageSpans`)
and nothing waits for the device to time them.  Where a call is given
`stats`, every rank's counters come back to rank 0 at the call's end, with
each rank's stage ms: from CUDA events where the call was given `marks`,
from the host clock otherwise (the CPU's gloo collectives block, so there
the host clock holds the waits).  While rank 0's spans record (a profiler,
or `profiling.recording()`), the helpers record theirs too.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import threading
import time
import traceback
import weakref
from multiprocessing.connection import wait

import numpy as np
import torch
import torch.distributed as dist

from nicetpu_torch.convert import to_rgb
from nicetpu_torch.dist.comm import RankCall
from nicetpu_torch.dist.launch import free_port
from nicetpu_torch.dist.multihost import initialize_distributed
from nicetpu_torch.dist.sharded import encode_rank, share_bytes, splits
from nicetpu_torch.dist.sharded_decode import decode_raster, decode_rank, gather_raster
from nicetpu_torch.format import headers
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3
from nicetpu_torch.utils import profiling

DEFAULT_TIMEOUT = 600.0  # seconds the set-up, a call and each collective may take
CLOSE_WAIT = 30.0  # seconds a helper is given to leave on close before it is killed
PARENT_POLL = 0.5  # seconds between a helper's checks that rank 0's process lives
COUNTERS = ("rasters", "fallbacks", "overflow_fallbacks", "host_served", "scattered_bytes",
            "records_bytes", "device_stitches")
RANK_COUNTERS = ("records_bytes", "recon_chains", "recon_cluster_chains")  # summed per rank
CFG = decode3.LADDER[-1]  # the sharded decode's walk: the robust rung
WHOLE_ON_HOST = {"rasters": 1, "fallbacks": 1, "host_served": 1}  # a raster that does not split


def _stage_ms(marks) -> dict:
    """Stage -> ms between consecutive (stage, CUDA event) marks, summed by
    the later mark's name; waits for the last event only."""
    out: dict = {}
    if marks:
        marks[-1][1].synchronize()
    for (_, a), (name, b) in zip(marks, marks[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def _serve(fn, comm, device: torch.device, args: tuple, opts: dict, marks=None):
    """fn(RankCall, *args) on this rank; returns (its result, its counters
    or None where the caller asked for no stats)."""
    t0 = time.perf_counter()
    if marks is None and opts["marks"]:
        marks = []
        profiling.mark_stage(marks, "call_start")
    call = RankCall(comm, device, {} if opts["stats"] else None, marks)
    with profiling.recording() if opts["traced"] else contextlib.nullcontext():
        result = fn(call, *args)
    if call.stats is None:
        return result, None
    counters = {k: v for k, v in call.stats.items() if k not in ("stages", "gates")}
    counters["host_served"] = int(bool(counters.get("fallbacks") or counters.get("overflow_fallbacks")))
    counters["stage_ms"] = (_stage_ms(marks) if marks
                            else {k: 1e3 * v for k, v in call.stats.get("stages", {}).items()})
    counters["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
    if opts["traced"]:
        counters["span_ms"] = profiling.spans(since=t0).total_ms
    return result, counters


def _rank_device(device: str, rank: int) -> torch.device:
    """Rank r's device: card r or the CPU."""
    return torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _watch_parent(parent: int) -> None:
    while True:
        time.sleep(PARENT_POLL)
        if os.getppid() != parent:
            os._exit(1)


def _helper_main(rank: int, n: int, port: int, device: str, conn, parent: int,
                 timeout: float) -> None:
    """A helper rank: join the group, then serve ("call", fn, args, opts)
    messages until ("close",).  An exception is sent to rank 0 with its
    traceback and ends the process at once, so that peers blocked in a
    collective with it see its connections close."""
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    try:
        dev = _rank_device(device, rank)
        conn.send(("up", None))
        comm = initialize_distributed(backend=_backend(device), init_method=f"tcp://127.0.0.1:{port}",
                                      world_size=n, rank=rank, device=dev.index, timeout=timeout)
        conn.send(("ready", None))
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                break
            _, fn, args, opts = msg
            conn.send(("done", _serve(fn, comm, dev, args, opts)[1]))
        dist.destroy_process_group()
    except EOFError:  # rank 0's end of the pipe is gone
        os._exit(1)
    except BaseException:
        with contextlib.suppress(OSError, ValueError):
            conn.send(("error", traceback.format_exc()))
        os._exit(1)


class _State:
    """What the group's finalizer holds: its processes and pipes, rank 0's
    pinned staging buffer, and the reason it closed (None while open)."""

    def __init__(self, backend: str) -> None:
        self.backend = backend
        self.procs: list = []
        self.conns: list = []
        self.staging = None  # rank 0's Comm.staging
        self.joined = False  # this process is rank 0 of a process group
        self.closed: str | None = None
        self.lock = threading.Lock()


def _kill(state: _State) -> None:
    for p in state.procs:
        if p.is_alive():
            p.kill()


def _break(state: _State, reason: str) -> None:
    """Close the group after a failure: kill the helpers, so that rank 0's
    collectives with them end, and abort rank 0's NCCL communicators."""
    with state.lock:
        if state.closed is None:
            state.closed = reason
    _kill(state)
    if state.backend == "nccl" and state.joined:
        import torch.distributed.distributed_c10d as c10d

        abort = getattr(c10d, "_abort_process_group", None)
        if abort is not None:
            with contextlib.suppress(Exception):
                abort()


def _shutdown(state: _State) -> None:
    """Close the group: ask each helper to leave, kill any that does not
    within CLOSE_WAIT, and leave rank 0's process group."""
    with state.lock:
        clean = state.closed is None
        state.closed = state.closed or "closed"
    if clean:
        for conn in state.conns:
            with contextlib.suppress(OSError, ValueError):
                conn.send(("close",))
    deadline = time.monotonic() + (CLOSE_WAIT if clean else 0.0)
    for p in state.procs:
        p.join(max(0.0, deadline - time.monotonic()))
    _kill(state)
    for p in state.procs:
        p.join()
    for conn in state.conns:
        conn.close()
    if state.staging is not None:
        state.staging.release()
    if state.joined:
        state.joined = False
        if dist.is_initialized() and (clean or state.backend != "nccl"):
            with contextlib.suppress(Exception):
                dist.destroy_process_group()


class _Replies:
    """Reads every helper's reply `kind` ("up" and "ready" in the set-up,
    "done" to a call) in a thread of its own, so that a helper's error,
    death or a reply past the deadline closes the group (and so ends rank
    0's waits) while rank 0 computes."""

    def __init__(self, state: _State, timeout: float, kind: str = "done") -> None:
        self.state, self.kind, self.deadline = state, kind, time.monotonic() + timeout
        self.counters: dict = {}
        self.failure: str | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        st = self.state
        pending = {conn: r + 1 for r, conn in enumerate(st.conns)}
        while pending and self.failure is None:
            left = self.deadline - time.monotonic()
            if left <= 0:
                self._fail(f"no {self.kind!r} within the time limit from ranks {sorted(pending.values())}")
                break
            alive = {st.procs[r - 1].sentinel: conn for conn, r in pending.items()}
            ready = wait(list(pending) + list(alive), timeout=min(left, 1.0))
            for conn in {alive.get(obj, obj) for obj in ready}:
                rank = pending.pop(conn)
                try:  # a helper that died still gives what it sent, then EOF
                    kind, val = conn.recv()
                except (EOFError, OSError):
                    kind, val = "error", "it exited without a reply"
                if kind != self.kind:
                    self._fail(f"rank {rank} failed:\n{val}")
                    break
                self.counters[rank] = val

    def _fail(self, reason: str) -> None:
        self.failure = reason
        _break(self.state, reason)

    def join(self, grace: float | None = None) -> str | None:
        """Wait for every reply, or at most `grace` seconds; the failure
        seen so far, if any."""
        self.thread.join(grace)
        return self.failure


class ShardGroup:
    """n ranks, one a card, that serve encodes, decodes and round trips of
    one raster a call; also a context manager.

    device: "cuda" (NCCL, rank r on cuda:r; needs n cards) or "cpu" (gloo,
    the kernels' plain versions).
    timeout: seconds the set-up, each call and each collective may take.
    The caller's process joins the group as rank 0, so it must not already
    belong to a `torch.distributed` group."""

    def __init__(self, n: int = 4, *, device: str = "cuda", timeout: float = DEFAULT_TIMEOUT) -> None:
        if device not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' was requested but CUDA is not available")
            if n > torch.cuda.device_count():
                raise ValueError(f"{n} ranks need {n} cards ({torch.cuda.device_count()} here)")
            from nicetpu_torch.kernels import build

            build.load()  # once here, before the helpers look for the library
        if n < 1:
            raise ValueError("a group needs at least one rank")
        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a torch.distributed group")
        self.n, self.timeout = n, timeout
        self.device = _rank_device(device, 0)
        self._state = st = _State(_backend(device))
        self._finalizer = weakref.finalize(self, _shutdown, st)
        ctx = mp.get_context("spawn")
        port = free_port()
        try:
            for r in range(1, n):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=_helper_main, name=f"nicetpu-shard-{r}", daemon=True,
                                args=(r, n, port, device, theirs, os.getpid(), timeout))
                p.start()
                theirs.close()
                st.procs.append(p)
                st.conns.append(mine)
            self._await("up")
            self._comm = initialize_distributed(backend=st.backend, init_method=f"tcp://127.0.0.1:{port}",
                                                world_size=n, rank=0, device=self.device.index,
                                                timeout=timeout)
            st.joined = True
            st.staging = self._comm.staging
            self._await("ready")
        except BaseException:
            _break(st, "set-up failed")
            self._finalizer()
            raise

    def _await(self, kind: str) -> None:
        """Wait for `kind` from every helper; raise on an error, a death or
        the time limit."""
        failure = _Replies(self._state, self.timeout, kind).join()
        if failure is not None:
            raise RuntimeError(failure)

    def close(self) -> None:
        """Stop the helpers and leave the process group (idempotent)."""
        self._finalizer()

    def __enter__(self) -> ShardGroup:
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _call(self, fn, root_args: tuple, helper_args: tuple, stats: dict | None = None, marks=None):
        """fn(call, *args) on every rank, `call` a `RankCall`, rank 0 with
        root_args and the helpers with helper_args; returns rank 0's result.
        fn and helper_args travel to the helpers by pickle: fn must be
        importable by name."""
        st = self._state
        if st.closed is not None:
            raise RuntimeError(f"the shard group is closed ({st.closed.splitlines()[0]})")
        opts = {"stats": stats is not None, "traced": profiling.enabled(),
                "marks": marks is not None and self.device.type == "cuda"}
        try:
            for conn in st.conns:
                conn.send(("call", fn, helper_args, opts))
        except OSError as e:
            _break(st, f"a rank is gone: {e}")
            raise RuntimeError(f"the shard group lost a rank: {e}") from e
        replies = _Replies(st, self.timeout)
        try:
            result, mine = _serve(fn, self._comm, self.device, root_args, opts,
                                  marks if opts["marks"] else None)
        except BaseException as e:
            failure = replies.join(grace=5.0)
            if failure is not None:
                raise RuntimeError(failure) from e
            _break(st, f"rank 0 failed: {type(e).__name__}: {e}")
            raise
        try:
            failure = replies.join()
        except BaseException as e:
            _break(st, f"interrupted: {type(e).__name__}")
            raise
        if failure is not None:
            raise RuntimeError(failure)
        if stats is not None:
            _merge(stats, {0: mine, **replies.counters}, self.n)
        return result

    def encode(self, img: np.ndarray, *, stats: dict | None = None, marks=None) -> bytes:
        """The `.nice` bytes of an (H, W, 3|4) uint8 raster, equal to
        `hostref.encode_native`'s."""
        img = to_rgb(img)
        H, W, _ = img.shape
        if not splits(H, W, self.n):
            _add(stats, WHOLE_ON_HOST)
            return oracle.encode_native(img)
        return self._call(_encode_rank, (img, H, W), (None, H, W), stats, marks)

    def decode(self, data: bytes, *, stats: dict | None = None, marks=None) -> np.ndarray:
        """The (H, W, 3) uint8 raster of `.nice` bytes."""
        W, H, channels = headers.parse_file_header(data)
        if channels != 3:
            raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
        if not splits(H, W, self.n):
            _add(stats, WHOLE_ON_HOST)
            return oracle.decode_native(data)
        return self._call(_decode_rank, (data,), (None,), stats, marks)

    def roundtrip(self, img: np.ndarray, *, stats: dict | None = None, keep_decoded: bool = False,
                  marks=None):
        """Encode a raster across the ranks and prove on the cards that the
        bytes decode back to it.  Returns (bytes, verified), and the decoded
        raster third with keep_decoded=True (gathered to rank 0 and copied
        to the host).  verified is True where every rank decoded its block
        exactly, or, on the host route, where the host decoder did.

        stats: optional dict; accumulates "rasters", "fallbacks",
        "overflow_fallbacks", "host_served", "scattered_bytes" (the row
        blocks sent to ranks 1 ... n - 1), "records_bytes" (rank 0's
        records all-gather), "device_stitches" (files the stitch kernel
        wrote on card 0: 0 on the host routes and on the CPU),
        "group_calls" (calls the group ran, whose counters follow) and,
        under "ranks", each rank's
        "peak_device_bytes" (the largest), "stage_ms", "records_bytes",
        "recon_chains" and "recon_cluster_chains" (the chains it
        reconstructed, and those on a thread-block cluster) and, while spans
        record, "span_ms".  marks: a list receives rank 0's
        (stage, CUDA event) marks, and every rank times its stages by
        events."""
        img = to_rgb(img)
        H, W, _ = img.shape
        if not splits(H, W, self.n):
            data = oracle.encode_native(img)
            out = oracle.decode_native(data)
            _add(stats, WHOLE_ON_HOST)
            ok = bool(np.array_equal(out, img))
            return (data, ok, out) if keep_decoded else (data, ok)
        data, ok, out = self._call(_roundtrip_rank, (img, H, W, keep_decoded),
                                   (None, H, W, keep_decoded), stats, marks)
        return (data, ok, out) if keep_decoded else (data, ok)


def _add(stats: dict | None, counters: dict) -> None:
    """Add a call's counters (rank 0's, or those of a raster the host
    served whole, the group untouched) to the caller's stats."""
    if stats is not None:
        for k in COUNTERS:
            stats[k] = stats.get(k, 0) + counters.get(k, 0)


def _merge(stats: dict, counters: dict, n: int) -> None:
    """Add one call's counters of every rank to the caller's stats."""
    _add(stats, counters[0])
    stats["group_calls"] = stats.get("group_calls", 0) + 1
    ranks = stats.setdefault("ranks", [{} for _ in range(n)])
    for r, c in counters.items():
        mine = ranks[r]
        mine["peak_device_bytes"] = max(mine.get("peak_device_bytes", 0), c["peak_device_bytes"])
        for key in RANK_COUNTERS:
            mine[key] = mine.get(key, 0) + c.get(key, 0)
        for key in ("stage_ms", "span_ms"):
            for stage, ms in c.get(key, {}).items():
                mine.setdefault(key, {})
                mine[key][stage] = mine[key].get(stage, 0.0) + ms


def _scatter(call: RankCall, img, height: int, width: int) -> torch.Tensor:
    """This rank's row block (n_local, 3) uint8 on its device, scattered
    from rank 0's one upload of the raster."""
    n = call.comm.size
    n_local = height // n * width
    full = None
    if call.root:
        with call.stages.stage("upload"):
            full = torch.from_numpy(img).to(call.device).view(n, n_local, 3)
    with call.stages.stage("scatter"):
        x = call.comm.scatter_root(full, (n_local, 3), torch.uint8, call.device)
    if call.root:
        call.count("scattered_bytes", (n - 1) * n_local * 3)
    return x


def _encode_rank(call: RankCall, img, height: int, width: int) -> bytes | None:
    call.count("rasters")
    return encode_rank(call, _scatter(call, img, height, width), img, height, width)[0]


def _decode_rank(call: RankCall, data: bytes | None) -> np.ndarray | None:
    call.count("rasters")
    return decode_raster(call, share_bytes(call, data), CFG, everywhere=False)


def _roundtrip_rank(call: RankCall, img, height: int, width: int, keep: bool):
    """One round trip on this rank; (bytes, verified, decoded raster or
    None) on rank 0, None elsewhere."""
    call.count("rasters")
    x = _scatter(call, img, height, width)
    data, file = encode_rank(call, x, img, height, width)
    data = share_bytes(call, data, file)
    del file  # card 0 holds no copy of the file through the decode
    block = decode_rank(call, data, CFG)
    if block is None:
        if not call.root:
            return None
        out = oracle.decode_native(data)
        return data, bool(np.array_equal(out, img)), out if keep else None
    with call.stages.stage("verify"):
        wrong = (block != x.T).any().to(torch.int64).reshape(1)
        verified = int(call.comm.psum(wrong)[0]) == 0
    del x
    out = gather_raster(call, block, height, width) if keep else None
    return (data, verified, out) if call.root else None
