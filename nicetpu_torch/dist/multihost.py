"""Encode and decode of one raster across processes, the result on rank 0.

Counterpart of `nicetpu/dist/multihost.py`.  `initialize_distributed`
wraps `torch.distributed.init_process_group`, with the backend and the
rendezvous given by the caller: nothing is read from a cluster, and a
missing NCCL raises instead of turning into gloo.  The sharded pipelines of
`sharded.py` and `sharded_decode.py` run unchanged; the result is assembled
on rank 0 only, and the payload's ordered gather stays bounded as JAX's
`_fetch_words_bounded` keeps it: first the shards' bit counts are gathered,
then every shard's words are trimmed to the longest shard's, and only those
go to rank 0.  (`jax.distributed` and `_fetch_replicated` have no
counterpart: every rank already holds its own shard.)
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from nicetpu_torch.config import resolve_device
from nicetpu_torch.dist.comm import Comm, RankCall
from nicetpu_torch.dist.sharded import encode_raster
from nicetpu_torch.dist.sharded_decode import decode_raster

BACKENDS = ("nccl", "gloo")


def initialize_distributed(*, backend: str = "nccl", init_method: str, world_size: int, rank: int,
                           device: int | None = None, timeout: float | None = None) -> Comm:
    """`torch.distributed.init_process_group` with an explicit backend and
    rendezvous (for example init_method="tcp://localhost:29500").  Under
    NCCL the rank's CUDA device is set first (`device`, else rank modulo the
    device count); NCCL without CUDA, or a build without NCCL, raises.
    timeout: seconds the rendezvous and each collective may wait (torch's
    default where None).  Returns the default group's `Comm`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    if backend == "nccl":
        if not dist.is_nccl_available() or not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA and a PyTorch built with NCCL")
        torch.cuda.set_device(device if device is not None else rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return Comm()


def encode_multihost(img: np.ndarray, *, device="cuda", group=None,
                     stats: dict | None = None) -> bytes | None:
    """Encode a raster across all ranks; every rank passes the same raster.
    Returns the `.nice` bytes on rank 0 and None elsewhere."""
    return encode_raster(RankCall(Comm(group), resolve_device(device), stats), img, everywhere=False)


def decode_multihost(data: bytes, *, device="cuda", group=None, cfg=None,
                     stats: dict | None = None) -> np.ndarray | None:
    """Decode a `.nice` raster across all ranks; every rank passes the same
    bytes.  Returns the (H, W, 3) uint8 raster on rank 0 and None
    elsewhere."""
    return decode_raster(RankCall(Comm(group), resolve_device(device), stats), data, cfg, everywhere=False)
