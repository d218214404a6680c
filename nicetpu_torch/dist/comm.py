"""The collectives of the sharded codec over `torch.distributed`.

The JAX package runs its sharded code inside `shard_map`, whose collectives
(`ppermute`, `all_gather`, `psum`) run over the mesh.  Here every rank is a
process of a `torch.distributed` group, and `Comm` holds that group and the
device its collectives run on: the rank's CUDA device under NCCL, the CPU
under gloo, where tensors are staged through host memory.  Every method
takes and returns tensors on the caller's device and moves them as needed.
A `Comm` also holds the rank's pinned staging buffer (`PinnedStaging`),
through which a file on the card comes to the host as bytes.

`RankCall` is one rank's part of one call of the sharded codec: its `Comm`,
its device, its stages (spans "dist.<stage>") and its counters.  Every
per-rank step of `sharded` and `sharded_decode` takes one, whichever entry
made it: the SPMD entries (`encode_sharded`, `decode_sharded` and the
`multihost` pair) on every rank, or `ShardGroup` on each of its ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nicetpu_torch.utils.profiling import StageSpans


class PinnedStaging:
    """A page-locked host buffer reused across calls, through which a 1-D
    uint8 tensor on a card comes to the host as `bytes`: one copy down at
    the link's rate into pages that stay mapped, then the bytes object.  The
    buffer is sized by the largest tensor so far and freed by `release`."""

    def __init__(self) -> None:
        self.buf: torch.Tensor | None = None

    def to_bytes(self, t: torch.Tensor) -> bytes:
        if t.device.type != "cuda":
            return t.numpy().tobytes()
        n = t.numel()
        if self.buf is None or self.buf.numel() < n:
            self.buf = None  # the old buffer goes before the larger one is pinned
            self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        view = self.buf[:n]
        view.copy_(t)  # waits for the copy
        return view.numpy().tobytes()

    def release(self) -> None:
        self.buf = None


class Comm:
    """One rank's view of a process group (the default group if None)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized (see multihost.initialize_distributed)")
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        backend = dist.get_backend(self.group)
        if backend == "nccl":
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"unsupported backend {backend!r}: use 'nccl' or 'gloo'")
        self.staging = PinnedStaging()

    def _global(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def _on(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device).contiguous()

    def ppermute(self, t: torch.Tensor) -> torch.Tensor:
        """Rank d sends t to rank d + 1; returns what rank d - 1 sent (zeros
        on rank 0), like `jax.lax.ppermute` with pairs (i, i + 1).  Sends and
        receives are posted together, so no order of ranks can deadlock."""
        x = self._on(t)
        buf = torch.zeros_like(x)
        ops = []
        if self.rank + 1 < self.size:
            ops.append(dist.P2POp(dist.isend, x, self._global(self.rank + 1), self.group))
        if self.rank > 0:
            ops.append(dist.P2POp(dist.irecv, buf, self._global(self.rank - 1), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return buf.to(t.device)

    def send_next(self, t: torch.Tensor) -> None:
        """Send t to rank d + 1 (nothing on the last rank)."""
        if self.rank + 1 < self.size:
            dist.send(self._on(t), self._global(self.rank + 1), self.group)

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """Receive from rank d - 1 a tensor shaped like `like` (zeros on rank 0)."""
        buf = torch.zeros_like(self._on(like))
        if self.rank > 0:
            dist.recv(buf, self._global(self.rank - 1), self.group)
        return buf.to(like.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        x = self._on(t)
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=self.device)
        dist.all_gather(list(out.unbind(0)), x, group=self.group)
        return out.to(t.device)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks."""
        x = self._on(t).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.to(t.device)

    def gather_root(self, t: torch.Tensor) -> torch.Tensor | None:
        """(size, *t.shape) on rank 0, in rank order; None elsewhere."""
        x = self._on(t)
        if self.rank == 0:
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=self.device)
            dist.gather(x, list(out.unbind(0)), dst=self._global(0), group=self.group)
            return out.to(t.device)
        dist.gather(x, None, dst=self._global(0), group=self.group)
        return None

    def scatter_root(self, t: torch.Tensor | None, shape: tuple, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
        """Rank 0's t, (size, *shape), cut along its first axis: piece r on
        rank r, on `device`; t is None on the other ranks."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        parts = list(self._on(t).unbind(0)) if self.rank == 0 else None
        dist.scatter(out, parts, src=self._global(0), group=self.group)
        return out.to(device)

    def broadcast_bytes(self, data: bytes | None, file: torch.Tensor | None = None) -> bytes:
        """Rank 0's bytes on every rank (rank 0 keeps its own object).  Where
        rank 0 holds them as a 1-D uint8 tensor too (`file`, the stitch's,
        on its card under NCCL), that tensor is sent and the bytes are not
        uploaded again."""
        if self.rank == 0:
            buf = self._on(file if file is not None else torch.frombuffer(bytearray(data), dtype=torch.uint8))
        n = torch.tensor([buf.numel() if self.rank == 0 else 0], dtype=torch.int64, device=self.device)
        dist.broadcast(n, self._global(0), group=self.group)
        if self.rank != 0:
            buf = torch.empty(int(n.item()), dtype=torch.uint8, device=self.device)
        dist.broadcast(buf, self._global(0), group=self.group)
        return data if self.rank == 0 else self.staging.to_bytes(buf)


class RankCall:
    """One rank's part of a call: its `Comm`, device and stages, and the
    dict its counters add to where the caller asked for stats (None
    otherwise).  marks: a list that receives (stage, CUDA event) marks."""

    def __init__(self, comm: Comm, device: torch.device, stats: dict | None = None, marks=None) -> None:
        self.comm, self.device, self.stats = comm, device, stats
        self.stages = StageSpans("dist", stats, marks)

    @property
    def root(self) -> bool:
        return self.comm.rank == 0

    def count(self, key: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + value
