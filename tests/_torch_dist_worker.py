"""Rank functions for tests/test_torch_dist.py, run by
`nicetpu_torch.dist.launch.run` in spawned processes.  This module imports
no JAX, so that each rank starts quickly."""

import time

import torch

from nicetpu_torch import bench_all
from nicetpu_torch.dist import launch, sharded
from nicetpu_torch.dist.multihost import decode_multihost, encode_multihost
from nicetpu_torch.dist.sharded import encode_sharded
from nicetpu_torch.dist.sharded_decode import decode_batch_sharded, decode_sharded
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import decode3


def sharded_cases(comm, images, blobs, cfg, batch, tall, tight_cfg, config5_side):
    """Every single-raster and batch case of the test file on one rank."""
    res = {"encode": [], "decode": []}
    for img in images:
        st: dict = {}
        res["encode"].append((encode_sharded(img, device="cpu", stats=st), st))
    for data in blobs:
        st = {}
        res["decode"].append((decode_sharded(data, device="cpu", cfg=cfg, stats=st), st))
    st = {}
    res["batch"] = (decode_batch_sharded(batch, device="cpu", stats=st), st)
    st = {}
    res["tall"] = (decode_sharded(tall, device="cpu", stats=st), st)
    st = {}
    res["tight"] = (decode_sharded(blobs[0], device="cpu", cfg=tight_cfg, stats=st), st)
    # a shard longer than the walk can hold goes to the host, counted
    limit = decode3.MAX_DEVICE_BITS
    decode3.MAX_DEVICE_BITS = 256
    try:
        st = {}
        res["over_limit"] = (decode_sharded(blobs[0], device="cpu", cfg=cfg, stats=st), st)
    finally:
        decode3.MAX_DEVICE_BITS = limit
    # the bench's config 5 rank function on a small raster
    res["config5"] = bench_all.config5_rank(comm, config5_side, "cpu", warm_side=config5_side // 2)

    # an overflow flag on rank 1 only sends the whole raster to the host
    place = sharded._fold_place_grouped_batched

    def overflow_on_rank_1(*args, **kwargs):
        words, totals, ovf = place(*args, **kwargs)
        return words, totals, ovf | (comm.rank == 1)

    sharded._fold_place_grouped_batched = overflow_on_rank_1
    try:
        st = {}
        res["overflow"] = (encode_sharded(images[0], device="cpu", stats=st), st)
    finally:
        sharded._fold_place_grouped_batched = place
    try:
        encode_sharded(images[0], device="cuda")
        res["cuda"] = "no error"
    except RuntimeError as e:
        res["cuda"] = str(e)
    return res


def multihost_pair(comm, img):
    """encode_multihost and decode_multihost on a pair of ranks, then the
    dry run's checks."""
    data = encode_multihost(img, device="cpu")
    out = decode_multihost(oracle.encode_native(img), device="cpu")
    dry = launch._dryrun_rank(comm, "cpu")
    return data, out, dry


def _staged(fn, arg):
    """fn(arg) on the CPU, and the stage names it left in its stats."""
    st: dict = {}
    return fn(arg, device="cpu", stats=st), set(st["stages"])


def spmd_rasters(comm, rasters, uneven):
    """The SPMD entries on each raster, with their stage names:
    encode_sharded and encode_multihost, then decode_sharded and
    decode_multihost of the bytes; and the ValueError of encode_sharded on
    a height that does not split over the ranks."""
    res = {}
    for name, img in rasters.items():
        runs = {"encode_sharded": _staged(encode_sharded, img), "encode_multihost": _staged(encode_multihost, img)}
        data = runs["encode_sharded"][0]
        runs.update(decode_sharded=_staged(decode_sharded, data), decode_multihost=_staged(decode_multihost, data))
        res[name] = runs
    try:
        encode_sharded(uneven, device="cpu")
        res["uneven"] = "no error"
    except ValueError as e:
        res["uneven"] = str(e)
    return res


def fail_on_rank_1(comm):
    if comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.all_gather(torch.zeros(1))  # waits for rank 1, which never comes
    return comm.rank


def sleep(comm, seconds):
    time.sleep(seconds)
    return comm.rank


def group_fail_on_rank_1(call):
    """A shard group rank function: rank 1 raises, the others wait for it
    in a collective."""
    if call.comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    call.comm.all_gather(torch.zeros(1))
    return call.comm.rank


def group_sleep_on_rank_1(call, seconds):
    """A shard group rank function: rank 1 sleeps, rank 0 returns."""
    if call.comm.rank == 1:
        time.sleep(seconds)
    return call.comm.rank


def sleep_group_rank(call):
    """A shard group rank function: every rank meets in one collective."""
    call.comm.all_gather(torch.zeros(1))
    return call.comm.rank
