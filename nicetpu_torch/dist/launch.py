"""Spawn n ranks of a function on this host, and the multi-rank dry run.

`run(fn, n, backend=..., device=...)` starts n processes (start method
`spawn`), initializes `torch.distributed` in each on a free loopback port,
calls fn(comm, *args) and returns the n results in rank order.  A rank's
exception fails the call with that rank's traceback; past `timeout` seconds
every rank is killed and the call raises.  The defaults are NCCL on the
card; backend="gloo", device="cpu" is the CPU form.  device "cuda" puts
rank r on CUDA device r modulo the device count; NCCL needs a card for each
rank, so several ranks on one card need gloo, and asking NCCL for more
ranks than cards raises.

`dryrun_multichip(n, backend, device)` is the counterpart of
`__graft_entry__.dryrun_multichip`: the same 8n x 128 image, encoded across
the n ranks to bytes equal to `hostref.encode_native`'s and decoded across
them to the image.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from nicetpu_torch.config import resolve_device
from nicetpu_torch.dist.multihost import initialize_distributed
from nicetpu_torch.dist.sharded import encode_sharded
from nicetpu_torch.dist.sharded_decode import decode_sharded
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import cuda_ops

DEFAULT_TIMEOUT = 300.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, backend: str, device: str, fn, args, out) -> None:
    try:
        if resolve_device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        comm = initialize_distributed(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                                      world_size=n, rank=rank)
        result = fn(comm, *args)
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        out.close()
        out.join_thread()
        os._exit(1)  # peers blocked in a collective are killed by the parent


def run(fn, n: int, *, backend: str = "nccl", device: str = "cuda", args: tuple = (),
        timeout: float = DEFAULT_TIMEOUT) -> list:
    """fn(comm, *args) on n spawned ranks; the n results in rank order.

    fn must be importable by name (a module-level function) and its
    arguments and result picklable."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if backend == "nccl":
        if device != "cuda" or not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs device='cuda' and CUDA")
        if n > torch.cuda.device_count():
            raise ValueError(f"backend 'nccl' needs a card for each of the {n} ranks "
                             f"({torch.cuda.device_count()} here); use backend='gloo'")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, backend, device, fn, args, out))
             for r in range(n)]
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks did not finish in {timeout:.0f} s "
                                   f"({len(results)} finished); every rank was killed")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                lost = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if lost:
                    raise RuntimeError(f"rank {lost[0]} exited with code {procs[lost[0]].exitcode} "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
    return [results[r] for r in range(n)]


def dryrun_image(n: int) -> np.ndarray:
    """`__graft_entry__.dryrun_multichip`'s image: 8n x 128, seeded."""
    rng = np.random.default_rng(1)
    H, W = 8 * n, 128
    return (rng.integers(0, 5, (H, W, 1)) * 50 + rng.integers(0, 4, (H, W, 3))).astype(np.uint8)


def _dryrun_rank(comm, device: str) -> dict:
    img = dryrun_image(comm.size)
    cuda_ops.reset_launches()
    estats: dict = {}
    dstats: dict = {}
    got = encode_sharded(img, device=device, stats=estats)
    want = oracle.encode_native(img)
    if got != want:
        raise AssertionError(f"sharded stream diverges from hostref: {len(got)} vs {len(want)} bytes")
    if estats["overflow_fallbacks"]:
        raise AssertionError(f"sharded encode fell back to the host: {estats}")
    dec = decode_sharded(got, device=device, stats=dstats)
    if not np.array_equal(dec, img):
        raise AssertionError("sharded decode diverges from the input")
    if dstats["fallbacks"]:
        raise AssertionError(f"sharded decode fell back to the host: {dstats}")
    return {"bytes": len(got), "launches": dict(cuda_ops.LAUNCHES), "real_slots": dstats["real_slots"]}


def dryrun_multichip(n: int, backend: str = "nccl", device: str = "cuda",
                     timeout: float = DEFAULT_TIMEOUT) -> list:
    """One sharded round trip over n spawned ranks on a small image: the
    encode (halo, summed histogram, run fix, local pack, ordered stitch)
    equal to `hostref.encode_native` and the decode (walk sharded by chunk
    ranges, cross-shard offsets, carry pipeline) equal to the image, with no
    host fallback.  NCCL on the card by default; backend="gloo",
    device="cpu" is the CPU form.  Returns each rank's {"bytes",
    "launches", "real_slots"}; raises on any mismatch."""
    res = run(_dryrun_rank, n, backend=backend, device=device, args=(device,), timeout=timeout)
    print(f"dryrun_multichip({n}, {backend!r}, {device!r}): OK — {res[0]['bytes']} bytes equal "
          "hostref.encode_native; sharded decode equals the image")
    return res
