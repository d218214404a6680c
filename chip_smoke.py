#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nicetpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one printed line or block each; any failure exits nonzero:
  0. the card's name and power limit (nvidia-smi); exit 1 without CUDA;
  1. build the CUDA kernels from csrc/ with nvcc (one process per source),
     print the build time and the register report;
  2. hold each of the twelve kernels against its plain PyTorch version on the
     card (exact equality) and time kernel, plain version and, where one
     PyTorch call computes the same function, that call (CUDA events).
     Encode kernels take seeded bins at the main path's shapes; the Huffman
     tables kernel takes the counts of the main path's first batch (int32,
     and int64 as the sharded path gives them), the deep, random, sparse,
     all-zero, heavy-symbol, tie and bound rows of tests/_huffman_rows.py
     (the deep rows' row 1 takes the clamped merge; the tie rows take
     equal-weight internal nodes out of creation order; the bound rows
     put stream totals either side of the kernel's int keys) and B = 1 and 32,
     and is timed at B = 1, 8 and 32 beside its earlier design's times;
     then build_tables_device and encode_fused_core run on the main path's
     batch under torch.cuda.set_sync_debug_mode("error"): one launch each
     of the tables kernel, one tokenizer call, no host sync; the tokenizer
     kernel (tokenize.tokenize_bins, one launch after one memset) takes the
     main path's batch at 3 and 11 run digits, a constant raster whose one
     run crosses every span, a raster that changes only at its last pixel
     (512x512, and 4096x4096: a run over 16,383 spans), spans alternating
     with and without changes, 64 512x512 images (more blocks than can be
     resident), W = 4, W = 1100 and W = 29051 rasters (at 5 and 0 digits
     too: the scalar stores; and a view that is not word-aligned) and a
     sharded rank's block (4-row halo, g0 > 0,
     the later shards' first changes from first_change as its tail), each
     exact with the overflow flags expected; 20 back-to-back calls equal;
     one call's device operations (torch.profiler) are its kernel and a
     memset, the sharded path's first_change and that kernel; it is timed
     at 8 x 512x512 and at 4096x4096; the decode tables kernel
     (decode3.prepare_tables_v3(walk=True) -> decode_tables: all ten tables,
     the walk's with the rest, in one launch) takes the code lengths of the
     main path's first batch (int32 from encode_fused_core, and again as
     int64, as the decode from bytes and the sharded decode upload them), of
     soccer0's committed stream, the deep, single-length, bad-value,
     past-2^32, Kraft and straddle rows of tests/_decode_table_rows.py
     (tables_ok false where it must be) and B = 1 and 32, the ten and the
     seven alone each exact against the plain pair; walk_tables
     (decode3.derive_walk_tables, off the decode paths) takes the rows'
     arbitrary words; then encode_fused_core -> prepare_tables_v3(walk=True)
     runs under torch.cuda.set_sync_debug_mode("error"): one launch, no host
     sync; a tables call is one device operation; the kernel is timed at
     B = 1, 8 and 32 beside an empty kernel's launch and one call's host
     microseconds beside the earlier two calls'; the decode
     kernels take the words, tables and records of a real 512x512x8 encode
     at the fast rung (the reconstruction's plain version, one step per
     pixel, is compared on the first 32 rows of each image), and then a
     real photo's stream at the robust rung: the top-left 512x512 of
     soccer0 from the committed corpus, mostly run digits (every walk
     round, the value join, and the reconstruction on its first 16 rows);
     the slot assembly kernels (cuda_ops.slot_assemble, three kernels and
     one read of the counts a call) take the final walk records of eight
     768x512 images at the fast and the robust rung and the records of
     tests/_slot_rows.py, each exact against slot_assemble_plain, timed
     beside the plain version and the bare torch cumsum/cummax/nonzero chain,
     with each kernel's device time from torch.profiler; the stitch kernel
     (cuda_ops.stitch_file) takes the shard layouts of tests/_stitch_rows.py
     at every header length, then four shards of 14.3 M words (a 16384^2
     raster's over four ranks), each exact against its plain version, timed
     beside its bound, the plain version (host numpy, with the words' copy
     down) and one call as rank 0 makes it (the kernel, one copy of the
     file down through a pinned staging buffer, the bytes; and the same
     through pageable memory); the reconstruction on thread-block clusters
     (rows past one block's shared memory): exact against its plain
     version at 4,352 and 16,384 wide with zeros and with a random carry
     above, on random forms and with CONST, lag-2 and lag-3 pixels on
     every slice seam and the row's wrap, each launch counted on a
     cluster; then timed (CUDA events) on one rank's block of the
     four-card raster (1 x 4096 rows x 16,384 with a random carry) beside
     the one-block kernel on a 4096x4096 raster, on random forms and on
     forms that read lag 1 only (HALF and CONST), each beside its bound;
     then config 4's largest device batch (api.plan_batches' first of
     bench_all's 100 texture patches: 8 images 579-760 wide, zero-padded
     to the largest, with their geometry table) through the tokenizer (3
     and 11 digits), the slot assembly (the robust rung's walk records)
     and the reconstruction: one counted launch each, each exact image by
     image against the plain version (the reconstruction on each image's
     first 32 rows, and whole against the images, zeros past each), each
     table launch timed beside one scalar launch an image;
  3. encode 64 512x512 RGB8 images in 8 batches of 8 through
     nicetpu_torch.encode_batch(device=dev.type), the two-step encode: every
     blob equals the native encoder's, none falls back, every encode kernel
     runs in every batch; MB/s; then the fused encode's per-stage
     milliseconds (pipeline.encode_batch_fused);
  4. the same for one 4096x4096 RGB8 image;
  5. the main path: the same 64 images through
     nicetpu_torch.roundtrip_batch(device=dev.type) in 8 batches of 8: every
     image verified on the device, 0 fallbacks, every blob equal to the
     native encoder's, the nine kernels of the path launched in every
     batch and walk_tables never (the walk's tables come with the decode
     tables, once a batch); MB/s and per-stage milliseconds of the round
     trip;
  6. decode the 64 blobs with nicetpu_torch.decode_batch(device=dev.type):
     exact arrays, 0 fallbacks, the decode tables and decode kernels
     launched in every batch, walk_tables never; MB/s;
  7. the round trip of one 4096x4096 image, with peak device memory;
  8. the scheduler: the 64 images as 8 uploaded batches of 8 through
     pipeline.roundtrip_hybrid, with one GPU worker, with two, and with one
     and two GPU workers beside one host worker: results complete and in order, every
     blob equal to the native encoder's, every array equal to its image, 0
     fallbacks, every path kernel launched at least once per GPU batch; MB/s and
     the GPU/host split of each run; then the 64 images through
     Pipeline.encode_many with the pool at its default width and at 1, 2
     and 4 threads, every blob equal to the native encoder's; MB/s of each;
  9. the CLI on the card: one 512x512 PNG through nicetpu_torch.cli.main to
     .nice and back with the default backend (where PIL is absent, the same
     image through api.encode and api.decode with the "cuda" backend);
 10. the sharded codec (nicetpu_torch.dist): (a) the walk's shard offsets and
     the reconstruction's carry at full size, exact: the final-round walk
     over the 4096x4096 raster's words as 4 shard-local walks, each re-based
     to its slice's first bit, against the unsharded walk, its reconstruction as 4 row
     blocks chained through prev4 against the unsharded kernel, chained
     blocks at 5,000 wide (a cluster a chain) and at 70,000 wide (one block
     with device-memory scratch), and both kernels with their new arguments
     against their plain versions at small sizes (the reconstruction at
     those two widths too, with a carry and with zeros, each launch counted
     on its path); (b) the
     4096x4096 raster through encode_sharded and decode_sharded as 4 gloo
     ranks on the one card (NCCL will not put two ranks on one GPU; the
     contexts time-slice, so the timing says nothing of scaling): bytes
     equal to the native encoder's, raster exact, 0 fallbacks, the nine
     path kernels launched on every rank, seconds, MB/s and per-rank stage
     times; (c) decode_batch_sharded of 8 of the 512x512 blobs over the
     same 4 ranks, exact; (d) dryrun_multichip over one NCCL rank.  The
     spawned ranks run under a time limit of their own;
 11. the bench modules on the card, each line printed as the bench prints
     it: nicetpu_torch.bench (the headline, 2 repeats, then the hybrid
     section at 1, 2 and 3 GPU workers in turn, 3 repeats), nicetpu_torch.bench_all
     config 1 and config 3's 4096x4096 lines (1-2 repeats; the real-photo
     lines run in phase 13) and nicetpu_torch.bench_trace (the round
     trip's device trace and idle share); fails on `degraded`, on any
     fallback and on any unverified output;
 12. payloads of 2**31 bits or more: bench_all's config 5, the
     14336x14336 make_img raster (over 2**31 payload bits) through
     encode_sharded and decode_sharded on the robust rung as 4 gloo ranks on
     the one card, under a time limit of its own: every rank's bytes equal
     the native encoder's, the raster exact, 0 fallbacks, the walk, the
     value join and the reconstruction launched on every rank, per-rank
     peak device memory printed; then nicetpu_torch.decode_batch of the
     same bytes on the card, which sends the stream to the host codec
     (fallbacks 1), equal to the raster;
 13. the real-photo corpus (nicetpu_torch/data/realcorpus/, 8 images) at full
     size: each image through roundtrip_batch on the card, its bytes equal
     to the committed file, every path kernel launched where the fused encode
     did not overflow; per image the ratio, verified, retries, fallbacks,
     overflow fallbacks and the gates of every rung that fails on its bytes
     (rung_probe.single_device); each image's round-trip stage times and
     soccer0's decode stage times on each rung; decode_batch of the 8 committed files,
     exact; then nicetpu_torch.bench_real and bench_all's real-photo lines
     (config 2, config 3's 2048x2048 soccer0 and config 4: the 100 mixed
     texture patches through one api.roundtrip_batch, 13 device batches,
     bytes equal to the native encoder's), where a counted fallback is
     reported, not a failure;
 14. one device's memory: make_img(8192, 16384, 5) (1.57 G payload bits,
     below MAX_DEVICE_BITS) through decode_batch on the card, exact and
     with 0 fallbacks, its peak device memory beside the reckoning that
     sized its device batch, then each rung's gates and peak on its bytes
     (rung_probe.single_device); and the round trip of make_img(8192,
     8192, 5), verified on the device, with its peak;
 15. the two-step encode (encode2.encode_batch, host-built Huffman tables):
     nicetpu_torch.bench_huffman_dev at B = 1, 4 and 8 (fused against
     two-step, equal bits, bytes equal to the native encoder's); the 64
     512x512 images through nicetpu_torch.encode_batch, every blob equal to
     the native encoder's, its per-stage milliseconds beside phase 3's fused
     ones and its launch counts; the 8 real photos at full size through
     encode_batch, each equal to its committed file with 0 overflow
     fallbacks (soccer0 tokenized again with 11 run digits, camera_hsv on
     the card); make_img(8192, 16384, 5) through nicetpu_torch.encode,
     equal to the native encoder's, with its seconds and peak device
     memory; and the tokenizer, histogram and fold kernels against their
     plain versions at the 11-digit layout (16 slots a pixel, 128 a group);
 16. the last benches and backends: nicetpu_torch.bench_profile (the fused
     encode's dispatch, payload fetch, assembly and native batch decode at
     B = 8, 16 and 32 of 512x512), nicetpu_torch.bench_decode_profile (the
     decode core's stages at 512x512x8) and nicetpu_torch.bench_multihost
     (the 1024x512 raster through encode_multihost on 1, 2 and 4 gloo ranks
     on the one card), each line printed as the bench prints it, every
     output exact and each bench's kernels launched; then one seeded 64x64
     image through api.encode and api.decode with the "spec" backend (the
     numpy codec), held against the native encoder, and an RGBA image
     through api.encode(alpha="error"), which must raise ValueError, and
     alpha="drop" on the card.
Phase 2 also holds the fold against its plain version off the main path's
shape.  The line before the last is the kernels' JSON record (launches from
phase 5, the two-step path's launches from phase 15, rank 0's on the sharded
path of phase 10, bench_profile's and bench_decode_profile's from phase
16, the histogram's and the fold's and the tokenizer's figures at 16
slots a pixel, the Huffman kernel's times at B = 1, 8 and 32, the
tokenizer's at 4096x4096, and the decode tables' at B = 1, 8 and 32 with
the empty-launch floor and the host microseconds; walk_tables, off the
main path, has `on_main_path` false, 0 launches there and its launches in
bench_decode_profile); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import nicetpu_torch
from nicetpu_torch import (bench, bench_all, bench_decode_profile, bench_decode_tables, bench_huffman_dev,
                           bench_multihost, bench_profile, bench_real, bench_trace, cli, pipeline, realcorpus,
                           rung_probe)
from nicetpu_torch.bench import card_line, make_image
from nicetpu_torch.config import RuntimeConfig
from nicetpu_torch.convert import from_int32_bits, tables_from_numpy
from nicetpu_torch.dist import launch, sharded_decode
from nicetpu_torch.dist.comm import PinnedStaging
from nicetpu_torch.format import constants as C
from nicetpu_torch.hostref import oracle
from nicetpu_torch.format.huffman import build_tables_host
from nicetpu_torch.kernels import build, cuda_ops, decode3, decode_dev, encode2, huffman_dev, recon
from nicetpu_torch.kernels import tokenize as tok
from nicetpu_torch.kernels.encode2 import encode_fused_core, mark_stage
from nicetpu_torch.kernels import geometry
from nicetpu_torch.kernels.geometry import Geometry



def _load_rows(name: str):
    """tests/<name>.py (numpy and the port only), loaded by its path so that
    nothing under tests/ can shadow a module this script imports."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_rows = _load_rows("_huffman_rows")
_table_rows = _load_rows("_decode_table_rows")
_slot_rows = _load_rows("_slot_rows")
_stitch_rows = _load_rows("_stitch_rows")
_recon_rows = _load_rows("_recon_rows")
_bounds, _deep, _heavy, _random, _sparse, _ties, _zero = (_rows._bounds, _rows._deep, _rows._heavy, _rows._random,
                                                         _rows._sparse, _rows._ties, _rows._zero)

SOURCES = {
    "histogram": "nicetpu_torch/csrc/encode_kernels.cu",
    "table_join": "nicetpu_torch/csrc/encode_kernels.cu",
    "fold_records": "nicetpu_torch/csrc/encode_kernels.cu",
    "walk": "nicetpu_torch/csrc/decode_kernels.cu",
    "value_join": "nicetpu_torch/csrc/decode_kernels.cu",
    "reconstruct_rows": "nicetpu_torch/csrc/decode_kernels.cu",
    "huffman_tables": "nicetpu_torch/csrc/huffman_kernels.cu",
    "tokenize": "nicetpu_torch/csrc/tokenize_kernels.cu",
    "decode_tables": "nicetpu_torch/csrc/decode_tables_kernels.cu",
    "walk_tables": "nicetpu_torch/csrc/decode_tables_kernels.cu",
    "slot_assemble": "nicetpu_torch/csrc/slot_assemble_kernels.cu",
    "stitch": "nicetpu_torch/csrc/stitch_kernels.cu",
}
REPLACES = {
    "histogram": "nicetpu/kernels/pallas_ops.py:100",
    "table_join": "nicetpu/kernels/pallas_ops.py:237",
    "fold_records": "nicetpu/kernels/pallas_ops.py:329",
    "walk": "nicetpu/kernels/decode3.py:546",
    "value_join": "nicetpu/kernels/pallas_ops.py:193",
    "reconstruct_rows": "nicetpu/kernels/recon_pallas.py:215",
    "huffman_tables": "nicetpu/kernels/huffman_dev.py:224 build_tables_device (jnp: fori_loop, cond, scan; "
                      "not Pallas)",
    "tokenize": "nicetpu/kernels/encode2.py:46 _tokenize_core (jnp inside the jitted tokenize_compact :72 and "
                "encode_fused :450; not Pallas)",
    "decode_tables": "nicetpu/kernels/decode3.py:1143 prepare_tables_v3_jnp and :180 derive_walk_tables of its "
                     "tables (jnp inside the jitted round trip :1619, jitted at :1646, and decode core :943; not "
                     "Pallas)",
    "walk_tables": "nicetpu/kernels/decode3.py:180 derive_walk_tables on any tables (jnp inside the jitted decode "
                   "core :943, jitted at :1044; not Pallas); on the decode paths through decode_tables",
    "slot_assemble": "nicetpu/kernels/decode3.py:651 _cumsum_walk and :667 _cummax_walk (jnp in-layout scans "
                     "inside the jitted decode core; not Pallas); in the port torch's cumsum, cummax and nonzero "
                     "of decode3._slot_starts and _compact before",
    "stitch": "none: nicetpu/dist/sharded.py stitch_payload is host numpy, and so was the port's rank 0 stitch "
              "before (stitch_payload, then the file's bytes)",
}
# what a batch of the round trip launches: every kernel but walk_tables,
# whose tables come with the decode tables, and the sharded encode's stitch
PATH_KERNELS = tuple(k for k in REPLACES if k not in ("walk_tables", "stitch"))
# the sharded decode assembles its slots with its own carried torch scans
SHARDED_KERNELS = tuple(k for k in PATH_KERNELS if k != "slot_assemble")
# the two-step encode (api.encode, the CLI) builds its Huffman tables on the host
HOST_TABLE_KERNELS = tuple(k for k in PATH_KERNELS if k != "huffman_tables")
# main path shapes: 8 images of 512x512, 8 token slots per pixel, 8 pixels a group
B, N, W512 = 8, 512 * 512, 512
M, MG, S = N * 8, N // 8, 64
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM published memory rate
OPS_PER_MS = 67e12 / 1e3  # published non-tensor-core rate (float32); the kernels' ops are int32
# the fold, per slot: offset split, the two record words (about 16), the window
# move, two ORs, the length sum and its range check
FOLD_OPS_PER_SLOT = 28
FOLD_EARLIER = ("0.2284 ms on an H100 80GB HBM3 at 700 W: one thread a group reading its slots from "
                "device memory, the record in ten registers with a ten-way select a slot")
HUFFMAN_EARLIER = ("0.4518 ms at B = 8 (0.4512 at 1, 0.8186 at 32) on an H100 80GB HBM3 at 700 W: 352 threads a "
                   "block, a block-wide pair-min each step, the clamp re-merge after the first merge")
HEAD_START_CYCLES = 20_000_000  # about 10 ms of device spin before a timed run of launches
RECON_CHECK_ROWS = 32  # rows per image for the reconstruction's plain comparison
RECON_RANDOM_ROWS = 64  # rows per image of the random-form comparison
NPAYLOAD = (1, 3, 4, 1, 3)  # payload codes of modes 0..4


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events).
    The stream first spins for about 10 ms, so that the host queues the calls
    ahead of the device and a slow host's launch pace is not read as the
    kernel's time."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest difference of the uint32 values the int32 tensors carry."""
    return int((from_int32_bits(got) - from_int32_bits(want)).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, ops: int) -> dict:
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def compare(name, kern, plain, library=None, reps=20, plain_reps=3, note="") -> dict:
    """Run kernel and plain version once each, require equal outputs, then
    time kernel, plain version and the library call."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    pairs = list(zip(got, want))
    check(all(g.shape == w.shape for g, w in pairs), f"{name}: kernel and plain shapes differ")
    same = all(torch.equal(g, w) for g, w in pairs)
    err = max(max_abs_err(g, w) for g, w in pairs)
    ms = cuda_ms(kern, reps)
    plain_ms = cuda_ms(plain, plain_reps, warmup=1)
    library_ms = cuda_ms(library, reps) if library is not None else None
    lib = f"{library_ms:.4f} ms" if library_ms is not None else "none"
    print(f"[kernel] {name}: exact={same} max_abs_err={err} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms library {lib} shapes={[tuple(g.shape) for g, _ in pairs]}{note}")
    check(same, f"{name} kernel disagrees with its plain version (max_abs_err {err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms}


def phase_encode_kernels(dev) -> dict:
    """The encode kernels against their plain versions at the main path's shapes."""
    rng = np.random.default_rng(0)
    bins = rng.integers(0, 858, (B, M), dtype=np.int32)
    bins[rng.random((B, M)) < 0.3] = 1023  # about 30 % holes
    lengths = rng.integers(1, 32, (B, 858), dtype=np.int32)
    codes = rng.integers(0, 2**32, (B, 858), dtype=np.uint64).astype(np.uint32)
    bins_d = torch.from_numpy(bins).to(dev)
    len_d = torch.from_numpy(lengths).to(dev)
    codes_d = torch.from_numpy(codes.view(np.int32)).to(dev)  # MSB set on half
    aob_d, code_d = cuda_ops.table_join_plain(bins_d, len_d, codes_d)
    aob2, code2 = aob_d.view(B, MG, S), code_d.view(B, MG, S)
    # library yardsticks, their inputs prepared here: one bincount over
    # image-offset bins; gathers from tables padded to 1024 columns
    offs = torch.where(bins_d < 858, bins_d + 858 * torch.arange(B, device=dev)[:, None], B * 858)
    offs = offs.flatten().to(torch.int64)
    idx64 = bins_d.to(torch.int64)
    len_pad = torch.nn.functional.pad(len_d, (0, 1024 - 858))
    codes_pad = torch.nn.functional.pad(codes_d, (0, 1024 - 858))

    out = {
        "histogram": compare(
            "histogram", lambda: cuda_ops.histogram(bins_d), lambda: cuda_ops.histogram_plain(bins_d),
            lambda: torch.bincount(offs, minlength=B * 858 + 1), plain_reps=10),
        "table_join": compare(
            "table_join", lambda: cuda_ops.table_join(bins_d, len_d, codes_d),
            lambda: cuda_ops.table_join_plain(bins_d, len_d, codes_d),
            lambda: (len_pad.gather(1, idx64), codes_pad.gather(1, idx64)), plain_reps=10),
        "fold_records": compare(
            "fold_records", lambda: cuda_ops.fold_records(aob2, code2),
            lambda: cuda_ops.fold_records_plain(aob2, code2)),
    }
    out["histogram"].update(bound(nbytes(bins_d) + B * 858 * 4, bins_d.numel()))
    out["table_join"].update(bound(nbytes(bins_d, len_d, codes_d) + 2 * nbytes(bins_d), bins_d.numel()))
    rec_k = cuda_ops.fold_records(aob2, code2)
    out["fold_records"].update(bound(nbytes(aob2, code2, *rec_k), FOLD_OPS_PER_SLOT * aob2.numel()))
    over = int((rec_k[1] > 32 * cuda_ops.FOLD_CAPW).sum())
    print(f"[kernel] fold_records at the main path's shape: {over} of {rec_k[1].numel()} records "
          f"over {32 * cuda_ops.FOLD_CAPW} bits (longest {int(rec_k[1].max())}); earlier: {FOLD_EARLIER}")
    check(over > 0, "the fold's main-shape input holds no record over 320 bits")
    fold_odd_shapes(dev)
    out["huffman_tables"] = huffman_kernel(dev)
    out["tokenize"] = tokenize_kernel(dev)
    out.update(decode_tables_kernels(dev))
    return out


HUFFMAN_B = (1, 8, 32)  # a sharded rank's batch, the main path's, bench_profile's largest
# a merge step, per slot of the stream: the pair-min's two compares, the
# slot's and the symbol's two key tests, the key and length updates
HUFFMAN_OPS_PER_SLOT_STEP = 6


def max_sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.split()[0])


def huffman_counts(dev, n: int) -> torch.Tensor:
    """(n, 858) int32 counts of make_image(512, 512, s) for s < n, as the
    round trip's histogram kernel gives them."""
    flat = pipeline.upload_batch([make_image(W512, W512, s) for s in range(n)], dev)
    bins, _ = encode2._tokenize_core(flat, width=W512, ndigits_cap=3)
    return cuda_ops.histogram(bins)


def huffman_work(counts: torch.Tensor) -> tuple[int, int]:
    """(slot-steps the plain merge needs for this data, where a stream whose
    merge passes 31 bits merges twice; the kernel's longest chain of merge
    steps: its clamped merge runs beside the first, in a warp of its own, so
    the chain is the largest alphabet's n - 2 whatever the data)."""
    cs = huffman_dev._counts_to_streams(counts.cpu().to(torch.int64))
    clamped = (huffman_dev._merge_lengths(cs) > C.MAX_CODE_LEN).any(dim=-1)  # (B, 10)
    sizes = torch.tensor(C.ALPHABET_SIZES, dtype=torch.int64)
    steps = (sizes - 2) * (1 + clamped.to(torch.int64))
    return int((steps * sizes).sum()), int((sizes - 2).max())


def huffman_kernel(dev) -> dict:
    """The Huffman tables kernel against its plain version, exact, on every
    listed input; its times at B = 1, 8 and 32; then one encode with no host
    sync between the histogram and the table join."""
    main = {b: huffman_counts(dev, b) for b in (8, 32)}
    rows = {"main path 8 x 512^2": main[8], "main path, int64": main[8].to(torch.int64),
            "deep (row 1 clamps)": _deep(), "random": _random(7), "sparse": _sparse(8), "zero": _zero(),
            "heavy": _heavy(9), "ties (equal-weight internal nodes out of creation order)": _ties(11),
            "bounds (stream totals at 2^20 - 1 and 2^20)": _bounds(14),
            "B=1": main[8][:1], "B=32": main[32]}
    for name, c in rows.items():
        c = c if isinstance(c, torch.Tensor) else torch.from_numpy(c).to(dev)
        got, want = huffman_dev.build_tables_device(c), huffman_dev.build_tables_device_plain(c)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"huffman_tables differs on {name}")
        slot_steps, chain = huffman_work(c)
        print(f"[kernel] huffman_tables on {name} {tuple(c.shape)} {c.dtype}: exact; {slot_steps} slot-steps, "
              f"longest chain {chain} merge steps")

    c8 = main[8]
    out = compare("huffman_tables", lambda: huffman_dev.build_tables_device(c8),
                  lambda: huffman_dev.build_tables_device_plain(c8), reps=20, plain_reps=2,
                  note=" (one launch a call; the plain version is some 7,000 small launches)")
    slot_steps = huffman_work(c8)[0]
    out.update(bound(nbytes(c8, *huffman_dev.build_tables_device(c8)), HUFFMAN_OPS_PER_SLOT_STEP * slot_steps))
    mhz = max_sm_mhz()
    ms_at, plain_at, chain_at = {}, {}, {}
    for b in HUFFMAN_B:
        cb = main[32][:b]
        ms_at[b] = cuda_ms(lambda: huffman_dev.build_tables_device(cb), 20)
        plain_at[b] = cuda_ms(lambda: huffman_dev.build_tables_device_plain(cb), 2, warmup=1)
        chain_at[b] = huffman_work(cb)[1]
    out.update(ms_at_B=ms_at, plain_ms_at_B=plain_at)
    step_us = {b: ms_at[b] * 1e3 / chain_at[b] for b in HUFFMAN_B}
    print(f"[kernel] huffman_tables at B = {HUFFMAN_B} of 512x512 make_image counts: kernel "
          f"{json.dumps(ms_at)} ms, plain {json.dumps(plain_at)} ms; longest chain {json.dumps(chain_at)} merge "
          f"steps, so a step took {json.dumps(step_us)} us (measured ms over steps; "
          f"{json.dumps({b: round(u * mhz) for b, u in step_us.items()})} cycles at the {mhz:.0f} MHz maximum "
          f"SM clock, the clock during the run not read); bound at B = 8 {out['bound_ms']:.6f} ms by "
          f"{out['bound_by']}; earlier: {HUFFMAN_EARLIER}", flush=True)

    # the fused encode's tables with no host sync: under "error" any sync raises
    flat = pipeline.upload_batch([make_image(W512, W512, s) for s in range(B)], dev)
    kw = dict(geom=Geometry.uniform(W512, N, B, dev), ndigits_cap=3, w_cap=pipeline.w_cap(N))
    encode_fused_core(flat, **kw)  # warm-up: the allocator's blocks
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tables = huffman_dev.build_tables_device(c8)
        _, lengths, _, ovf = encode_fused_core(flat, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(cuda_ops.LAUNCHES)
    check(launches["huffman_tables"] == 2, f"the tables took other than one launch a call: {launches}")
    check(launches["tokenize"] == 1, f"encode_fused_core did not tokenize through the kernel: {launches}")
    check(torch.equal(lengths, tables[0]) and not bool(ovf.any()), "the synchronization-free encode differs")
    print(f"[kernel] build_tables_device and encode_fused_core of {B} x 512x512 under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync; launches={launches}", flush=True)
    return out


# the cascade's integer operations a pixel, as counted from the source of
# the earlier three-launch design and kept so that the bound stays
# comparable: 16 probes (5 back references, 11 luma references of some 12
# operations each), the small difference, the second luma, the residuals,
# the mode select, 5 + S slot selects, the run and its digits; bytes bound
# the kernel either way
TOKENIZE_OPS_PER_PIXEL = 350
TOKENIZE_EARLIER = ("0.0637 ms at 8 x 512^2, 0.0982 at 16 slots, 0.5623 at 4096^2 on an H100 80GB HBM3 at 700 W: "
                    "three launches, 256-pixel tiles, probes of three byte loads from device memory")
TOKENIZE_KERNEL = "tokenize_kernel"
TOKENIZE_REPEATS = 20  # back-to-back calls that must agree: the per-call reset of tickets and words


PROFILE_SESSIONS = 3  # a later profiler session in one process may trace no device operation at all


def device_ops(fn) -> list:
    """Names of the device operations one call of fn runs (torch.profiler).
    Every fn given here launches at least one, so a session that traces
    none failed to trace: it is taken again, up to PROFILE_SESSIONS in all,
    and the last one's names (empty only if every session was) returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        on_dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if on_dev:
            break
        print("[profile] a profiler session traced no device operation: taken again", flush=True)
    return [e.name for e in on_dev]


def sharded_tokenize_case(dev) -> tuple:
    """Rank 1 of 4 row blocks of a 4096x1024 make_image raster with its
    4-row halo, its tail the first changes of ranks 2 and 3 (first_change on
    their blocks); the raster is constant from 3 rows before the end of
    block 1 to 5 rows into block 2, so the block's last run ends in a later
    shard."""
    H, W, n = 4096, 1024, 4
    img = make_image(H, W, 31)
    rows = H // n
    img[2 * rows - 3 : 2 * rows + 5] = img[2 * rows - 3, 0]
    flat = torch.from_numpy(img.reshape(1, H * W, 3)).to(dev)
    halo, n_local = tok.halo_pixels(W), rows * W

    def shard(r):
        lo = max(r * n_local - halo, 0)
        return flat[:, lo : (r + 1) * n_local].contiguous(), r * n_local - lo

    firsts = []
    for r in (2, 3):
        x, h = shard(r)
        got = tok.first_change(x, halo=h, g0=r * n_local, n_total=H * W)
        check(torch.equal(got, tok.first_change_plain(x, halo=h, g0=r * n_local, n_total=H * W)),
              f"first_change differs from its plain version on rank {r}'s block")
        firsts.append(got)
    x, h = shard(1)
    kw = dict(width=W, halo=h, g0=n_local, n_total=H * W, ndigits_cap=C.MAX_RUN_DIGITS,
              invalid_bin=C.TOTAL_SYMBOLS, tail=torch.cat(firsts))
    return x, kw


def tokenize_cases(dev) -> dict:
    """name -> (x_ext, tokenize_bins keywords, overflow expected or None)."""
    span = cuda_ops.TOKENIZE_SPAN
    main = pipeline.upload_batch([make_image(W512, W512, s) for s in range(B)], dev)
    const = torch.full((2, N, 3), 77, dtype=torch.uint8, device=dev)  # one run over every span
    last = torch.zeros(1, N, 3, dtype=torch.uint8, device=dev)
    last[0, -1] = 9  # a change only at the last pixel
    big_last = torch.zeros(1, 4096 * 4096, 3, dtype=torch.uint8, device=dev)
    big_last[0, -1] = 9  # 16,384 spans, all but the last one run
    alternate = pipeline.upload_batch([make_image(W512, W512, s) for s in range(2)], dev)
    for j in range(1, N // span, 2):  # every other span one run, the one before it a change at its end
        alternate[:, j * span : (j + 1) * span] = alternate[:, j * span - 1 : j * span]
    w4 = pipeline.upload_batch([make_image(4096, 4, s) for s in range(2)], dev)
    w1100 = pipeline.upload_batch([make_image(300, 1100, s) for s in range(3)], dev)
    w29051 = pipeline.upload_batch([make_image(5, 29051, s) for s in range(2)], dev)
    unaligned = w1100[:1, 1:]  # contiguous, its data one pixel past the allocation's start
    check(unaligned.is_contiguous() and unaligned.data_ptr() % 4 != 0, "the unaligned view is aligned")
    many = pipeline.upload_batch([make_image(W512, W512, s % 8) for s in range(64)], dev)

    def kw(x, width, cap):
        return dict(width=width, halo=0, g0=0, n_total=x.shape[1], ndigits_cap=cap, invalid_bin=encode2.INVALID_BIN)

    cases = {f"main path {B} x 512^2, cap {cap}": (main, kw(main, W512, cap), False)
             for cap in (3, C.MAX_RUN_DIGITS)}
    cases.update({
        "constant 512^2 x 2 (one run over every span), cap 3": (const, kw(const, W512, 3), True),
        "constant 512^2 x 2, cap 11": (const, kw(const, W512, C.MAX_RUN_DIGITS), False),
        "change only at the last pixel, cap 3": (last, kw(last, W512, 3), True),
        "4096^2, a change only at the last pixel (a run over 16,383 spans), cap 11":
            (big_last, kw(big_last, 4096, C.MAX_RUN_DIGITS), False),
        "512^2 x 2, spans alternating with and without changes, cap 3": (alternate, kw(alternate, W512, 3), None),
        "64 x 512^2 (more blocks than can be resident), cap 3": (many, kw(many, W512, 3), False),
        "W = 4, 4096 rows x 2, cap 3": (w4, kw(w4, 4, 3), None),
        "W = 4, cap 11": (w4, kw(w4, 4, C.MAX_RUN_DIGITS), None),
        "W = 1100, 300 rows x 3, cap 3": (w1100, kw(w1100, 1100, 3), None),
        "W = 1100, cap 5 (10 slots: the scalar stores)": (w1100, kw(w1100, 1100, 5), None),
        "W = 1100, a view 3 bytes past a word (pixel-by-pixel staging), cap 3": (unaligned, kw(unaligned, 1100, 3), None),
        "W = 29051, 5 rows x 2, cap 3": (w29051, kw(w29051, 29051, 3), None),
        "W = 29051, cap 0 (5 slots)": (w29051, kw(w29051, 29051, 0), None),
    })
    x, skw = sharded_tokenize_case(dev)
    cases["sharded: rank 1 of 4, 4-row halo, g0 > 0, tail, cap 11"] = (x, skw, False)
    return cases


def tokenize_kernel(dev) -> dict:
    """The tokenizer kernel against its plain version, exact, on every
    listed input; repeated calls equal; one call's device operations; its
    times at the main path's shape and at 4096^2."""
    for name, (x, kw, want_ovf) in tokenize_cases(dev).items():
        got, want = tok.tokenize_bins(x, **kw), tok.tokenize_bins_plain(x, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max_abs_err(got[0], want[0])
        ovf = got[1].tolist()
        print(f"[kernel] tokenize on {name} {tuple(x.shape)}: exact={same} max_abs_err={err}; "
              f"overflow {ovf if len(ovf) <= 8 else all(ovf) if want_ovf else any(ovf)}")
        check(same, f"tokenize differs from its plain version on {name} (max_abs_err {err})")
        check(want_ovf is None or all(o == want_ovf for o in ovf), f"tokenize's overflow on {name}: {ovf}")

    main = pipeline.upload_batch([make_image(W512, W512, s) for s in range(B)], dev)
    kw = dict(width=W512, halo=0, g0=0, n_total=N, ndigits_cap=3, invalid_bin=encode2.INVALID_BIN)
    first = tok.tokenize_bins(main, **kw)
    calls = [tok.tokenize_bins(main, **kw) for _ in range(TOKENIZE_REPEATS)]
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for c in calls for g, w in zip(c, first)),
          f"{TOKENIZE_REPEATS} back-to-back tokenize calls differ")
    print(f"[kernel] tokenize: {TOKENIZE_REPEATS} back-to-back calls on the main path's batch all equal")

    # one profiled window (a second profiler session in one process may
    # record no device operation): the main path's call, then the sharded
    # path's first_change (of its own block: only the launch is counted here)
    # and its call
    x, skw = sharded_tokenize_case(dev)
    sk = dict(halo=skw["halo"], g0=skw["g0"], n_total=skw["n_total"])

    def both():
        tok.tokenize_bins(main, **kw)
        torch.cuda.synchronize()
        tok.first_change(x, **sk)
        tok.tokenize_bins(x, **skw)

    names = device_ops(both)
    print(f"[kernel] tokenize: device operations of one call, then of the sharded path's first_change and "
          f"call: {names}")
    pattern = ["Memset", TOKENIZE_KERNEL, "first_change_kernel", "Memset", TOKENIZE_KERNEL]
    check(len(names) == len(pattern) and all(p in n for p, n in zip(pattern, names)),
          f"a tokenize call ran other device operations than one memset and one kernel, or the sharded path "
          f"other than first_change and that call: {names}")

    cuda_ops.reset_launches()
    out = compare("tokenize", lambda: tok.tokenize_bins(main, **kw), lambda: tok.tokenize_bins_plain(main, **kw),
                  plain_reps=3, note=" (one launch and one memset a call; the plain version is some 300 torch "
                                     "operations)")
    bins, ovf = tok.tokenize_bins(main, **kw)
    out.update(bound(nbytes(main, bins, ovf), TOKENIZE_OPS_PER_PIXEL * B * N))
    big = pipeline.upload_batch([make_image(4096, 4096, 99)], dev)
    kb = dict(kw, width=4096, n_total=4096 * 4096)
    at = compare("tokenize at 4096^2", lambda: tok.tokenize_bins(big, **kb),
                 lambda: tok.tokenize_bins_plain(big, **kb), reps=10, plain_reps=2)
    bins, ovf = tok.tokenize_bins(big, **kb)
    at.update(bound(nbytes(big, bins, ovf), TOKENIZE_OPS_PER_PIXEL * 4096 * 4096))
    out["at_4096"] = at
    print(f"[kernel] tokenize bound: {out['bound_ms']:.6f} ms at {B} x 512^2 ({out['ms'] / out['bound_ms']:.2f}x), "
          f"{at['bound_ms']:.6f} ms at 4096^2 ({at['ms'] / at['bound_ms']:.2f}x), both by {out['bound_by']}; "
          f"earlier: {TOKENIZE_EARLIER}", flush=True)
    return out


# decode_tables_kernel's integer operations an image, counted from its
# source: 33 a symbol (address, load, range check and clamp, the match, rank
# and count store; the slot's two shared loads, sums and stores) for 858
# symbols, 4 a (chunk, length) in the offset scan, and 130 a (stream,
# length) lane (two 5-step scans, one of them 64 bits wide, the Kraft total,
# the six stores, and the walk's suffix minimum, ballot, forward fill and
# three stores); walk_tables_kernel's 50 a (stream, length) lane
DECODE_TABLES_OPS_PER_IMAGE = 33 * 858 + 4 * 29 * 32 + 130 * 320
WALK_TABLES_OPS_PER_IMAGE = 50 * 320
DECODE_TABLES_B = (1, 8, 32)
DECODE_TABLES_EARLIER = ("two launches at B = 8 on an H100 80GB HBM3 at 700 W: decode_tables_kernel 0.0060 ms (one "
                         "warp a stream, 320 threads an image, the 343-symbol stream in 22 serial chunk steps) and "
                         "walk_tables_kernel 0.0023 ms")
HOST_REPS = 200  # calls whose median host time is read


def decode_tables_kernels(dev) -> dict:
    """The decode tables kernel (all ten tables, and the seven alone) and
    the walk_tables kernel against their plain versions, exact, on every
    listed input; one fused encode -> tables with no host sync in one
    launch; a call's device operations; times at B = 1, 8 and 32 beside an
    empty kernel's, and one call's host microseconds."""
    lens32 = bench_decode_tables.main_lengths(dev, 32)
    lens = lens32[:B].contiguous()  # the main path's first batch
    rows = {f"main path {B} x 512^2 (int32)": lens, "main path, int64": lens.to(torch.int64), "B=1": lens[:1],
            "B=32": lens32}
    rows.update({name: _table_rows.LENGTH_ROWS[name]()
                 for name in ("soccer0", "deep", "single_length", "bad_values", "past_2_32", "kraft", "straddle")})

    def plain_pair(x):
        tables = decode3.prepare_tables_v3_plain(x)
        return tables + decode3.derive_walk_tables_plain(*tables[:3])

    for name, row in rows.items():
        row = row if isinstance(row, torch.Tensor) else torch.from_numpy(row).to(dev)
        got, seven, want = decode3.prepare_tables_v3(row, walk=True), decode3.prepare_tables_v3(row), plain_pair(row)
        torch.cuda.synchronize()
        check(len(got) == 10 and all(torch.equal(g, w) for g, w in zip(got, want)), f"decode_tables differs on {name}")
        check(all(torch.equal(g, w) for g, w in zip(seven, want[:7])), f"decode_tables' seven differ on {name}")
        print(f"[kernel] decode_tables (ten, and the seven alone) on {name} {tuple(row.shape)} {row.dtype}: exact; "
              f"tables_ok {got[6].tolist() if row.shape[0] <= 8 else bool(got[6].all())}")
    check(bool(decode3.prepare_tables_v3(lens)[6].all()), "the main path's tables are not all valid")
    for name, make in _table_rows.WALK_ROWS.items():
        words = [torch.from_numpy(x).to(dev) for x in make()]
        got, want = decode3.derive_walk_tables(*words), decode3.derive_walk_tables_plain(*words)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"walk_tables differs on the {name} words")
        print(f"[kernel] walk_tables on the {name} words {tuple(words[0].shape)}: exact")

    # the round trip's tables with no host sync: under "error" any sync raises
    flat = pipeline.upload_batch([make_image(W512, W512, s) for s in range(B)], dev)
    kw = dict(geom=Geometry.uniform(W512, N, B, dev), ndigits_cap=3, w_cap=pipeline.w_cap(N))

    def fused():
        return decode3.prepare_tables_v3(encode_fused_core(flat, **kw)[1], walk=True)

    fused()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tables = fused()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(cuda_ops.LAUNCHES)
    check(launches["decode_tables"] == 1 and launches["walk_tables"] == 0,
          f"the ten tables took other than one launch: {launches}")
    want = plain_pair(lens)
    check(all(torch.equal(g, w) for g, w in zip(tables, want)), "the synchronization-free tables differ")
    print(f"[kernel] encode_fused_core -> prepare_tables_v3(walk=True) of {B} x 512x512 under "
          f"torch.cuda.set_sync_debug_mode('error'): no host sync; launches={launches}", flush=True)

    names = device_ops(lambda: decode3.prepare_tables_v3(lens, walk=True))
    check(len(names) == 1 and "decode_tables_kernel" in names[0],
          f"a decode tables call ran other device operations than its kernel: {names}")
    n_plain = [len(device_ops(lambda: decode3.prepare_tables_v3_plain(lens))),
               len(device_ops(lambda: decode3.derive_walk_tables_plain(*want[:3])))]
    print(f"[kernel] prepare_tables_v3(walk=True) at {B} images: device operations {names}; the plain versions "
          f"run {n_plain[0]} and {n_plain[1]} device operations (torch.profiler)", flush=True)
    out = {"decode_tables": compare(
        "decode_tables", lambda: decode3.prepare_tables_v3(lens, walk=True), lambda: plain_pair(lens),
        plain_reps=3, note=f" (all ten tables in one launch; the plain pair {sum(n_plain)} device operations)")}
    got = decode3.prepare_tables_v3(lens, walk=True)
    out["decode_tables"].update(bound(nbytes(lens, *got), DECODE_TABLES_OPS_PER_IMAGE * B))
    af, pr, ib = got[:3]
    out["walk_tables"] = compare(
        "walk_tables", lambda: decode3.derive_walk_tables(af, pr, ib),
        lambda: decode3.derive_walk_tables_plain(af, pr, ib), plain_reps=5,
        note=f" (arbitrary tables, off the decode paths; the plain version {n_plain[1]} device operations)")
    out["walk_tables"].update(bound(nbytes(af, pr, ib, *got[7:]), WALK_TABLES_OPS_PER_IMAGE * B))

    # the one launch at B = 1, 8, 32 beside the seven alone, the earlier
    # design's two launches (this source's kernels) and an empty kernel
    at = {b: lens32[:b] for b in DECODE_TABLES_B}
    ms_at = {b: cuda_ms(lambda: decode3.prepare_tables_v3(at[b], walk=True), 20) for b in DECODE_TABLES_B}
    seven_at = {b: cuda_ms(lambda: decode3.prepare_tables_v3(at[b]), 20) for b in DECODE_TABLES_B}
    pair_at = {b: cuda_ms(lambda: decode3.derive_walk_tables(*decode3.prepare_tables_v3(at[b])[:3]), 20)
               for b in DECODE_TABLES_B}
    empty = bench_decode_tables.empty_launch_ms(dev)
    host = {"one call": bench_decode_tables.host_us(lambda x: decode3.prepare_tables_v3(x, walk=True), lens,
                                                     HOST_REPS),
            "two calls": bench_decode_tables.host_us(
                lambda x: decode3.derive_walk_tables(*decode3.prepare_tables_v3(x)[:3]), lens, HOST_REPS)}
    out["decode_tables"].update(ms_at_B=ms_at, seven_ms_at_B=seven_at, two_launches_ms_at_B=pair_at,
                                empty_launch_ms=empty, host_us=host)
    print(f"[kernel] decode_tables at B = {DECODE_TABLES_B}: the ten in one launch {json.dumps(ms_at)} ms, the seven "
          f"alone {json.dumps(seven_at)} ms, seven then walk_tables (two launches) {json.dumps(pair_at)} ms; an "
          f"empty kernel (blocks x threads) {json.dumps(empty)} ms; host us of one call without a sync (median of "
          f"{HOST_REPS}): {json.dumps(host)}; earlier: {DECODE_TABLES_EARLIER}", flush=True)
    for name in ("decode_tables", "walk_tables"):
        r = out[name]
        print(f"[kernel] {name} at {B} images: {r['ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
              f"({r['ms'] / r['bound_ms']:.0f}x), plain {r['plain_ms']:.4f} ms", flush=True)
    return out


def fold_odd_shapes(dev) -> None:
    """The fold on shapes off the main path, each exact: S = 13 on an
    unaligned view with a group count that fills no whole block; lengths up
    to 32 with every record over 320 bits; lengths outside 0..32."""
    rng = np.random.default_rng(13)

    def slots(b, mg, s, top, holes, lead=0):
        n = b * mg * s
        aob = rng.integers(0, top + 1, n + lead).astype(np.int32)
        aob[rng.random(n + lead) < holes] = 0
        code = rng.integers(0, 2**32, n + lead, dtype=np.uint64).astype(np.uint32).view(np.int32)
        return [torch.from_numpy(a).to(dev)[lead:].view(b, mg, s) for a in (aob, code)]

    cases = {
        "S=13, 1,003 groups, unaligned view": slots(2, 1003, 13, 31, 0.4, lead=1),
        "S=64, lengths to 32, no holes": slots(2, 1003, 64, 32, 0.0),
        "S=64, lengths outside 0..32": slots(2, 1003, 64, 31, 0.4),
    }
    check(cases["S=13, 1,003 groups, unaligned view"][0].data_ptr() % 16 != 0, "the view is aligned")
    outside = cases["S=64, lengths outside 0..32"][0]
    outside[:, ::5, 7], outside[:, 1::5, 40], outside[:, 2::5, 0] = 33, -3, 2**20
    for what, (a, c) in cases.items():
        got, want = cuda_ops.fold_records(a, c), cuda_ops.fold_records_plain(a, c)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        print(f"[kernel] fold_records, {what}: exact={same} max_abs_err={err}; "
              f"records over 320 bits: {int((want[1] > 320).sum())} of {want[1].numel()}")
        check(same, f"fold_records disagrees with its plain version ({what})")
    check(bool((cuda_ops.fold_records_plain(*cases["S=64, lengths to 32, no holes"])[1] > 320).all()),
          "the long-record case holds a record within 320 bits")


def phase_decode_kernels(dev) -> dict:
    """walk, value_join and reconstruct_rows on the words, tables and
    records of a real 512x512x8 encode at the fast rung."""
    imgs = [make_image(N // W512, W512, 100 + s) for s in range(B)]
    flat = pipeline.upload_batch(imgs, dev)
    cfg = decode3.LADDER[0]
    w_cap = decode3.roundtrip_cap_words(N)
    geom = Geometry.uniform(W512, N, B, dev)
    words, lengths, totals, ovf = encode_fused_core(flat, geom=geom, ndigits_cap=3, w_cap=w_cap)
    check(not bool(ovf.any()), "the kernel phase's encode overflowed")
    af, pr, ib, pfx, sym_tbl, _, ok, aff, dD, inc = decode3.prepare_tables_v3(lengths, walk=True)
    wi = decode3._fit_words(words, decode3._wcap_one((32 * (w_cap - 2)) // 8, cfg))
    wbits = totals.to(torch.int32)
    nch = (wi.shape[1] - decode3._wrows(cfg.chunk_bits)) // (cfg.chunk_bits // 32)
    steps = decode3._steps(cfg.chunk_bits, cfg.steps_div)
    e0 = (torch.arange(nch, dtype=torch.int32, device=dev) * cfg.chunk_bits).expand(B, nch).contiguous()
    kw = dict(chunk_bits=cfg.chunk_bits, steps=steps)
    ex1 = decode3.walk(wi, e0, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
    ex1_plain = decode3.walk_plain(wi, e0, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
    check(torch.equal(ex1, ex1_plain), "walk round 1 exits disagree with the plain version")
    e = torch.cat([torch.zeros_like(ex1[:, :1]), ex1[:, :-1]], dim=1).contiguous()
    print(f"[kernel] walk inputs: words {tuple(wi.shape)}, {nch} chunks x {steps} steps, "
          f"payload bits {totals.tolist()}; round 1 exits equal the plain version's")

    rec_ms = cuda_ms(lambda: decode3.walk(wi, e, aff, dD, inc, pfx, wbits, **kw), 20)
    norec_ms = cuda_ms(lambda: decode3.walk(wi, e, aff, dD, inc, pfx, wbits, records=False, **kw), 20)
    print(f"[kernel] walk final round: {rec_ms:.4f} ms with records, {norec_ms:.4f} ms without "
          f"(the record stores' share: {1 - norec_ms / rec_ms:.3f})")
    out = {"walk": compare(
        "walk", lambda: decode3.walk(wi, e, aff, dD, inc, pfx, wbits, **kw),
        lambda: decode3.walk_plain(wi, e, aff, dD, inc, pfx, wbits, **kw), plain_reps=1,
        note=" (final round, records stored)")}
    pos, sym, i12, i34, ex2 = decode3.walk(wi, e, aff, dD, inc, pfx, wbits, **kw)
    live = pos >= 0
    npay = torch.tensor(NPAYLOAD + (0,) * 11, device=dev)[sym.clamp(0, 15).long()]
    codes_n = int((live * (1 + npay)).sum())
    bits_walked = int((ex2 - e).clamp(min=0).sum())
    # per code: two word loads, a funnel shift and the index sum (~10 ops);
    # per threshold tested (code length + 1): compare, add, add (3 ops)
    walk_ops = 10 * codes_n + 3 * (bits_walked + codes_n)
    out["walk"].update(bound(nbytes(wi, e, aff, dD, inc, pfx, wbits, pos, sym, i12, i34, ex2),
                             walk_ops))
    print(f"[kernel] walk work: {int(live.sum())} groups, {codes_n} codes, {bits_walked} bits walked, "
          f"{walk_ops} integer ops")

    Sn = nch * steps
    bins = decode3._payload_bins(sym.view(B, Sn), i12.view(B, Sn), i34.view(B, Sn))
    tbl_pad = torch.nn.functional.pad(sym_tbl, (0, 1024 - 858)).expand(4, B, 1024)
    bins64 = bins.to(torch.int64)  # every payload bin is in [0, 1024): holes are 1023
    check(int(bins.min()) >= 0 and int(bins.max()) < 1024, "payload bins out of [0, 1024)")
    out["value_join"] = compare(
        "value_join", lambda: cuda_ops.value_join(bins, sym_tbl),
        lambda: cuda_ops.value_join_plain(bins, sym_tbl), lambda: tbl_pad.gather(2, bins64),
        plain_reps=5)
    out["value_join"].update(bound(2 * nbytes(bins) + nbytes(sym_tbl), bins.numel()))

    syms = cuda_ops.value_join(bins, sym_tbl)
    rec, dst, _ = decode3.assemble_v3(pos.view(B, Sn), sym.view(B, Sn), *syms, wbits, geom=geom)
    form, delta, refoff = decode3.place_and_unpack(rec, dst, geom=geom)
    n_chk = RECON_CHECK_ROWS * W512
    f_c, d_c, r_c = form[:, :n_chk].contiguous(), delta[:, :, :n_chk].contiguous(), refoff[:, :n_chk].contiguous()
    out["reconstruct_rows"] = compare(
        "reconstruct_rows", lambda: recon.reconstruct_rows(f_c, d_c, r_c, width=W512),
        lambda: decode_dev.reconstruct_rows(f_c, d_c, r_c, n_chk, W512), plain_reps=1,
        note=f" (compared and plain-timed at {B} x {RECON_CHECK_ROWS} rows x {W512})")
    full = recon.reconstruct_rows(form, delta, refoff, width=W512)
    want = flat.transpose(1, 2).to(torch.int32)
    check(torch.equal(full, want), "full-size reconstruction differs from the encoded images")
    # 1100: 35 segments, the last one ragged, through the two-level resolve
    for b_, h_, w_ in ((B, RECON_RANDOM_ROWS, W512), (2, 16, 1100)):
        args = [t.to(dev) for t in _recon_rows.random_inputs(b_, h_, w_, seed=w_)]
        got = recon.reconstruct_rows(*args, width=w_)
        want = decode_dev.reconstruct_rows(*args, h_ * w_, w_)
        err = max_abs_err(got, want)
        print(f"[kernel] reconstruct_rows on random forms at {b_} x {h_} rows x {w_}: "
              f"exact={torch.equal(got, want)} max_abs_err={err}")
        check(torch.equal(got, want), f"reconstruct_rows disagrees on random forms at width {w_}")
    out["reconstruct_rows"]["ms"] = cuda_ms(lambda: recon.reconstruct_rows(form, delta, refoff, width=W512), 20)
    out["reconstruct_rows"].update(bound(nbytes(form, delta, refoff, full), 10 * full.numel()))
    print(f"[kernel] reconstruct_rows at the main path's shape {tuple(full.shape)}: "
          f"{out['reconstruct_rows']['ms']:.4f} ms, equals the encoded images")
    return out


SLOT_IMAGES = 8  # the Kodak cell's batch (api.MAX_BATCH) of 768x512 images
SLOT_KERNELS = ("slot_summary_kernel", "slot_scan_kernel", "slot_compact_kernel")


def slot_library_chain(valid, sym):
    """The torch calls the slot kernels replace, bare: the int32 digit
    count, the running maximum, the int64 coverage sum and the nonzero."""
    kk = torch.cumsum(valid, dim=1, dtype=torch.int32)
    cd = torch.cummax(torch.where(sym < C.PREFIX_RUN_BASE, kk, -1), dim=1).values
    start = torch.cumsum(cd.to(torch.int64), dim=1)
    return torch.nonzero((start & 1).bool().view(-1))


def slot_device_ms(fn, reps: int = 10) -> dict:
    """Device ms a call of each slot kernel (torch.profiler), after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: 0.0 for k in SLOT_KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in SLOT_KERNELS:
                if k in e.name:
                    us[k] += e.time_range.end - e.time_range.start
    return {k: v / 1e3 / reps for k, v in us.items()}


def slot_assemble_kernel(dev) -> dict:
    """The slot assembly kernels against slot_assemble_plain: the final
    walk records of eight 768x512 images at each rung (the Kodak cell's
    batch and shape), then the adversarial records of tests/_slot_rows.py;
    timed at both rungs (the fast rung's row is the record's)."""
    imgs = [make_image(512, 768, 300 + s) for s in range(SLOT_IMAGES)]
    datas = [oracle.encode_native(im) for im in imgs]
    (words, wbits, af, pr, ib, pfx, _), (H, W) = decode3.prepare_batch_args(datas, device=dev)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    out = {}
    for cfg in decode3.LADDER:
        steps = decode3._steps(cfg.chunk_bits, cfg.steps_div)
        pos, sym, i12, i34, ok1, ok2 = decode3.walk_rounds(words, wbits, aff, dD, inc, pfx, chunk_bits=cfg.chunk_bits,
                                                           steps=steps, rounds=cfg.rounds)
        wb = wbits.to(torch.int32)
        N = H * W
        before = cuda_ops.LAUNCHES["slot_assemble"]
        res = compare(
            f"slot_assemble at {tuple(cfg)}", lambda: cuda_ops.slot_assemble(pos, sym, i12, i34, wb, n_pixels=N),
            lambda: decode3.slot_assemble_plain(pos, sym, i12, i34, wb, N),
            lambda: slot_library_chain((pos >= 0).view(pos.shape[0], -1), sym.view(pos.shape[0], -1)),
            note=f" ({pos.shape[0]} x {pos.shape[1]} chunks x {steps} steps; library: the bare torch chain)")
        check(cuda_ops.LAUNCHES["slot_assemble"] > before, "slot_assemble was not counted")
        got = cuda_ops.slot_assemble(pos, sym, i12, i34, wb, n_pixels=N)
        real = int(got[4].sum())
        # least bytes: pos and sym read once, i12 and i34 of the real slots, the (B, K) outputs written once
        res.update(bound(nbytes(pos, sym) + 8 * real + nbytes(*got[:5]), 0))
        res["device_ms"] = slot_device_ms(lambda: cuda_ops.slot_assemble(pos, sym, i12, i34, wb, n_pixels=N))
        res["slots"], res["real"], res["gates_ok"] = pos.numel(), real, bool(got[5].all() & ok1.all() & ok2.all())
        print(f"[kernel] slot_assemble at {tuple(cfg)}: {pos.numel()} slots, {real} real, K {got[0].shape[1]}, "
              f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}; device ms a kernel {res['device_ms']}; "
              f"gates {res['gates_ok']}", flush=True)
        out[cfg] = res
        del pos, sym, i12, i34, got
    for case in _slot_rows.CASES:
        for B_, steps in ((1, 256), (8, 1376)):
            rows = _slot_rows.records(case, B_, 37, steps, seed=steps)
            ts = [torch.from_numpy(a).to(dev) for a in rows[:5]]
            got = cuda_ops.slot_assemble(*ts, n_pixels=rows[5])
            want = decode3.slot_assemble_plain(*ts, rows[5])
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"slot_assemble disagrees with its plain version on the {case} records at {B_} x {steps}")
    print(f"[kernel] slot_assemble equals its plain version on the records {_slot_rows.CASES} at 1 x 256 and "
          f"8 x 1376", flush=True)
    fast, robust = (out[c] for c in decode3.LADDER)
    return {"slot_assemble": {**fast, "robust_rung": robust}}


STITCH_WORDS = 14_300_000  # words a shard of a 16384^2 raster over four ranks (raster16k-sharded4)
STITCH_SHARDS = 4


def stitch_kernel(dev) -> dict:
    """The stitch kernel against its plain version on the shard layouts of
    tests/_stitch_rows.py at every header length, then at the four-card
    cell's size: STITCH_SHARDS shards of STITCH_WORDS words, seeded totals
    near their capacity, a real file's 770-byte header length.  Timed
    beside its bound (the words the totals need read once, the file written
    once), the plain version on the host (with the words' copy down, as
    rank 0 stitched before) and one call as rank 0 makes it now (the
    kernel, one copy of the file down through the pinned staging buffer,
    the bytes), beside the same call through pageable memory."""
    for case, (bits, k) in _stitch_rows.CASES.items():
        for hlen in _stitch_rows.HEADER_LENGTHS:
            words, head = _stitch_rows.shards(bits, k, seed=hlen), _stitch_rows.header(hlen)
            got = cuda_ops.stitch_file(words.to(dev), bits, head)
            check(torch.equal(got.cpu(), cuda_ops.stitch_file(words, bits, head)),
                  f"stitch disagrees with its plain version on {case} with a {hlen}-byte header")
    print(f"[kernel] stitch equals its plain version on {list(_stitch_rows.CASES)} with headers of "
          f"{_stitch_rows.HEADER_LENGTHS} bytes", flush=True)
    bits = _stitch_rows.random_bits(STITCH_SHARDS, STITCH_WORDS, seed=2)
    words = _stitch_rows.shards(bits, STITCH_WORDS, seed=2)
    head = _stitch_rows.header(770)
    wd = words.to(dev)
    before = cuda_ops.LAUNCHES["stitch"]
    got = cuda_ops.stitch_file(wd, bits, head)
    torch.cuda.synchronize()
    check(cuda_ops.LAUNCHES["stitch"] == before + 1, "stitch was not counted")
    check(torch.equal(got.cpu(), cuda_ops.stitch_file(words, bits, head)),
          "stitch disagrees with its plain version at the four-card cell's size")
    res = {"max_abs_err": 0, "ms": cuda_ms(lambda: cuda_ops.stitch_file(wd, bits, head), 20),
           "library_ms": None}
    plain = []
    for _ in range(2):
        t0 = time.perf_counter()
        cuda_ops.stitch_file(wd.cpu(), bits, head)
        plain.append(1e3 * (time.perf_counter() - t0))
    staging = PinnedStaging()
    calls = {"call_ms": staging.to_bytes, "pageable_call_ms": lambda f: f.cpu().numpy().tobytes()}
    for key, down in calls.items():
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            down(cuda_ops.stitch_file(wd, bits, head))
            ms.append(1e3 * (time.perf_counter() - t0))
        res[key] = min(ms)
    staging.release()
    res["plain_ms"] = min(plain)
    res.update(bound(4 * int(sum(-(-int(b) // 32) for b in bits)) + got.numel(), 0))
    print(f"[kernel] stitch at {STITCH_SHARDS} x {STITCH_WORDS} words ({int(bits.sum())} bits, a "
          f"{got.numel()}-byte file): kernel {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}; plain (host, words copied down) {res['plain_ms']:.1f} ms; rank 0's call "
          f"(kernel, one copy down through the pinned buffer, bytes) {res['call_ms']:.1f} ms, through "
          f"pageable memory {res['pageable_call_ms']:.1f} ms", flush=True)
    return {"stitch": res}


RECON_BLOCK = (4096, 16384)  # rows and width of one rank's block of the four-card raster
RECON_CLUSTER_CHECKS = (4352, 16384)  # cluster widths held against the plain version, 2 rows each


def lag1_recon_inputs(h: int, w: int, seed: int):
    """Forms that read lag 1 only: HALF, and CONST at a fifth of the pixels
    (drawn from the width's offsets), as on photographic content."""
    _, delta, _ = _recon_rows.random_inputs(1, h, w, seed)
    const = torch.from_numpy(np.random.default_rng(seed).random((1, h * w)) < 0.2)
    form = torch.where(const, 0, 4).to(torch.int32)
    choices = torch.tensor(decode_dev._const_offsets(w), dtype=torch.int32)
    pick = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, len(choices), (1, h * w)))
    return form, delta, torch.where(const, choices[pick], 0).to(torch.int32)


def recon_cluster_kernel(dev) -> dict:
    """Rows past one block's shared memory, on a cluster a chain: exact
    against the plain version, then the four-card raster's rank block
    timed beside the one-block kernel at 4,096 wide."""
    for w in RECON_CLUSTER_CHECKS:
        ctas = recon.cluster_ctas(w, dev)
        check(ctas > 1, f"width {w} does not run on a cluster")
        for name, make in (("random", _recon_rows.random_inputs), ("seams", _recon_rows.seam_inputs)):
            args = [t.to(dev) for t in make(1, 2, w, w)]
            prev4 = torch.from_numpy(np.random.default_rng(w).integers(0, 256, (1, 3, 4 * w))
                                     .astype(np.int32)).to(dev)
            before = cuda_ops.LAUNCHES["reconstruct_rows_cluster"]
            got = recon.reconstruct_rows(*args, width=w), recon.reconstruct_rows(*args, width=w, prev4=prev4)
            check(cuda_ops.LAUNCHES["reconstruct_rows_cluster"] == before + 2, "cluster launches not counted")
            same = (torch.equal(got[0], decode_dev.reconstruct_rows(*args, 2 * w, w))
                    and all(torch.equal(g, x) for g, x in
                            zip(got[1], decode_dev.reconstruct_rows(*args, 2 * w, w, prev4=prev4))))
            print(f"[kernel] reconstruct_rows on a cluster of {ctas} CTAs a chain at 1 x 2 rows x {w}, "
                  f"{name} forms, zeros and a random carry above: exact={same}", flush=True)
            check(same, f"the cluster reconstruction disagrees with its plain version at width {w} ({name})")
    res = {}
    H, W = RECON_BLOCK
    for forms, make in (("random", _recon_rows.random_inputs), ("lag1", None)):
        for h, w in ((H, W), (H, H)):
            args = [t.to(dev) for t in (make(1, h, w, 7) if make else lag1_recon_inputs(h, w, 7))]
            prev4 = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (1, 3, 4 * w))
                                     .astype(np.int32)).to(dev)
            out, _ = recon.reconstruct_rows(*args, width=w, prev4=prev4)
            ms = cuda_ms(lambda: recon.reconstruct_rows(*args, width=w, prev4=prev4), 3, warmup=1)
            b = bound(nbytes(*args, out), 0)
            ctas = recon.cluster_ctas(w, dev)
            key = f"{forms}_{h}x{w}"
            res[f"{key}_ms"], res[f"{key}_bound_ms"], res[f"{key}_ctas"] = ms, b["bound_ms"], ctas
            print(f"[kernel] reconstruct_rows at 1 x {h} rows x {w}, {forms} forms, a random carry: "
                  f"{ms:.3f} ms ({'a cluster of %d CTAs a chain' % ctas if ctas else 'one block a chain'}), "
                  f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({ms / b['bound_ms']:.0f}x)", flush=True)
    return res


REAL_CROP = 512  # side of phase 2's soccer0 crop (the plain walk takes it in seconds)
REAL_CHECK_ROWS = 16  # rows of that crop for the reconstruction's plain comparison


def phase_decode_kernels_real(dev) -> None:
    """The three decode kernels against their plain versions on a real
    photo's stream at the robust rung: the top-left 512x512 of soccer0,
    mostly run digits, from the committed corpus."""
    img = np.ascontiguousarray(dict(realcorpus.load_corpus())["soccer0"][:REAL_CROP, :REAL_CROP])
    data = oracle.encode_native(img)
    cfg = decode3.LADDER[-1]
    (wi, wbits, af, pr, ib, pfx, sym_tbl), (H, W) = decode3.prepare_batch_args([data], device=dev)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    nch = (wi.shape[1] - decode3._wrows(cfg.chunk_bits)) // (cfg.chunk_bits // 32)
    kw = dict(chunk_bits=cfg.chunk_bits, steps=decode3._steps(cfg.chunk_bits, cfg.steps_div))
    e = (torch.arange(nch, dtype=torch.int32, device=dev) * cfg.chunk_bits)[None].contiguous()
    pfx = pfx.contiguous()
    for r in range(cfg.rounds):
        final = r == cfg.rounds - 1
        got = decode3.walk(wi, e, aff, dD, inc, pfx, wbits, records=final, **kw)
        want = decode3.walk_plain(wi, e, aff, dD, inc, pfx, wbits, records=final, **kw)
        check(all(torch.equal(g, x) for g, x in zip(got, want) if g is not None),
              f"walk round {r + 1} disagrees with its plain version on the real stream")
        if not final:
            e = torch.cat([torch.zeros_like(got[4][:, :1]), got[4][:, :-1]], dim=1).contiguous()
    pos, sym, i12, i34, _ = got
    live = pos >= 0
    digits = int((live & (sym >= C.PREFIX_RUN_BASE)).sum())
    S = pos.numel()
    bins = decode3._payload_bins(sym.view(1, S), i12.view(1, S), i34.view(1, S))
    syms = cuda_ops.value_join(bins, sym_tbl)
    check(torch.equal(syms, cuda_ops.value_join_plain(bins, sym_tbl)),
          "value_join disagrees with its plain version on the real stream")
    geom = Geometry.uniform(W, H * W, 1, dev)
    rec, dst, gates = decode3.assemble_v3(pos.view(1, S), sym.view(1, S), *syms, wbits, geom=geom)
    form, delta, refoff = decode3.place_and_unpack(rec, dst, geom=geom)
    n_chk = REAL_CHECK_ROWS * W
    cut = [t[..., :n_chk].contiguous() for t in (form, delta, refoff)]
    check(torch.equal(recon.reconstruct_rows(*cut, width=W), decode_dev.reconstruct_rows(*cut, n_chk, W)),
          "reconstruct_rows disagrees with its plain version on the real stream")
    full = recon.reconstruct_rows(form, delta, refoff, width=W)
    check(all(bool(g.all()) for g in gates) and
          torch.equal(full, torch.from_numpy(img.reshape(1, -1, 3)).to(dev).transpose(1, 2).to(torch.int32)),
          "the real stream's robust-rung decode differs from the image")
    print(f"[kernel] real stream (soccer0 {REAL_CROP}x{REAL_CROP}, ratio {img.nbytes / len(data):.2f}, "
          f"{decode3.payload_bits(data)} payload bits) at the robust rung {tuple(cfg)}: {cfg.rounds} walk "
          f"rounds ({nch} chunks x {kw['steps']} steps; {int(live.sum())} groups, {digits} of them run "
          f"digits) equal walk_plain; value_join equals its plain version; reconstruct_rows equals its "
          f"plain version on the first {REAL_CHECK_ROWS} rows and the image in full")


MIXED_REPS = 10  # timed calls of each kernel on the mixed batch


def phase_mixed_kernels(dev) -> None:
    """Config 4's largest device batch (the first of `api.plan_batches` on
    bench_all's 100 texture patches: 8 images 579-760 wide, zero-padded to
    the largest) through the tokenizer, the slot assembly and the
    reconstruction with the batch's geometry table: one counted launch
    each, exact against the plain versions image by image (and the slot
    assembly against its plain version of the whole batch), the
    reconstruction equal to the images with zeros past each; each table
    launch timed beside one scalar launch an image."""
    t0 = time.perf_counter()
    stream = bench_all.texture_patches(bench_all.mixed_sizes(), seed=9)
    batch = [stream[i] for i in nicetpu_torch.api.plan_batches(stream, dev)[0]]
    flat = pipeline.upload_batch(batch, dev)
    geom = pipeline.batch_geometry(batch, flat)
    shapes = list(zip(geom.widths, geom.n_pixels))
    check(len(shapes) == nicetpu_torch.api.MAX_BATCH and len(set(geom.widths)) == len(shapes),
          f"config 4's first batch holds {shapes}")
    inv = encode2.INVALID_BIN
    times = {}

    for cap in (3, C.MAX_RUN_DIGITS):
        before = cuda_ops.LAUNCHES["tokenize"]
        bins, ovf = tok.tokenize_images(flat, geom=geom, ndigits_cap=cap, invalid_bin=inv)
        check(cuda_ops.LAUNCHES["tokenize"] == before + 1, "the mixed batch's tokenizer was not one counted launch")
        S = 5 + cap
        for b, (w, n) in enumerate(shapes):
            x = flat[b : b + 1, :n].contiguous()
            want = tok.tokenize_bins_plain(x, width=w, halo=0, g0=0, n_total=n, ndigits_cap=cap, invalid_bin=inv)
            check(torch.equal(bins[b, : n * S], want[0][0]) and bool(ovf[b]) == bool(want[1][0])
                  and bool((bins[b, n * S :] == inv).all()),
                  f"the table tokenizer differs from the plain version on image {b} ({n // w}x{w}) at {cap} digits")
    xs = [(flat[b : b + 1, :n].contiguous(), w, n) for b, (w, n) in enumerate(shapes)]
    times["tokenize"] = (
        cuda_ms(lambda: tok.tokenize_images(flat, geom=geom, ndigits_cap=3, invalid_bin=inv), MIXED_REPS),
        cuda_ms(lambda: [tok.tokenize_bins(x, width=w, halo=0, g0=0, n_total=n, ndigits_cap=3, invalid_bin=inv)
                         for x, w, n in xs], MIXED_REPS))
    del xs

    # the robust rung's walk records: every image of the set decodes there
    w_cap = decode3.roundtrip_cap_words(geom.n_max)
    words, lengths, totals, ovf = encode_fused_core(flat, geom=geom, ndigits_cap=3, w_cap=w_cap)
    check(not bool(ovf.any()), "the mixed batch's fused encode overflowed")
    af, pr, ib, pfx, sym_tbl, _, tables_ok, aff, dD, inc = decode3.prepare_tables_v3(lengths, walk=True)
    cfg = decode3.LADDER[-1]
    wi = decode3._fit_words(words, decode3._words_cap((int(totals.max()) + 7) // 8, (cfg,)))
    wbits = totals.to(torch.int32)
    steps = decode3._steps(cfg.chunk_bits, cfg.steps_div)
    pos, sym, i12, i34, ok1, ok2 = decode3.walk_rounds(wi, wbits, aff, dD, inc, pfx, chunk_bits=cfg.chunk_bits,
                                                       steps=steps, rounds=cfg.rounds)
    before = cuda_ops.LAUNCHES["slot_assemble"]
    got = cuda_ops.slot_assemble(pos, sym, i12, i34, wbits, geom=geom)
    check(cuda_ops.LAUNCHES["slot_assemble"] == before + 1, "the mixed batch's slot assembly was not one counted call")
    whole = decode3.slot_assemble_plain(pos, sym, i12, i34, wbits, geom.column(geometry.N).to(torch.int64))
    check(all(torch.equal(g, w) for g, w in zip(got, whole)),
          "the table slot assembly differs from its plain version of the batch")
    for b, (w, n) in enumerate(shapes):
        alone = decode3.slot_assemble_plain(*(t[b : b + 1] for t in (pos, sym, i12, i34, wbits)), n)
        k = alone[0].shape[1]
        check(all(torch.equal(g[b, :k], a[0]) for g, a in zip(got[:5], alone[:5]))
              and bool(got[5][b]) == bool(alone[5][0]),
              f"the table slot assembly differs from image {b}'s alone ({n // w}x{w})")
    del pos, sym, i12, i34, got, whole

    form, delta, refoff, gates = decode3.decode_planes_v3(wi, wbits, af, pr, ib, pfx, sym_tbl, geom=geom,
                                                          chunk_bits=cfg.chunk_bits, steps=steps, rounds=cfg.rounds,
                                                          walk_tables=(aff, dD, inc))
    check(bool(gates.all() & tables_ok.all()), f"the mixed batch's robust-rung gates: {gates.tolist()}")
    before = cuda_ops.LAUNCHES["reconstruct_rows"]
    out = recon.reconstruct_rows(form, delta, refoff, geom=geom)
    check(cuda_ops.LAUNCHES["reconstruct_rows"] == before + 1, "the mixed batch's reconstruction was not one launch")
    check(torch.equal(out, flat.transpose(1, 2).to(torch.int32)),
          "the table reconstruction is not the images with zeros past each")
    cut = []
    for b, (w, n) in enumerate(shapes):
        one = [t[b : b + 1, ..., :n].contiguous() for t in (form, delta, refoff)]
        m = min(RECON_CHECK_ROWS, n // w) * w
        plain = decode_dev.reconstruct_rows(*(t[..., :m].contiguous() for t in one), m, w)
        check(torch.equal(out[b, :, :m], plain[0]),
              f"the table reconstruction differs from the plain version on image {b}'s first rows ({w} wide)")
        cut.append((one, w))
    times["reconstruct_rows"] = (
        cuda_ms(lambda: recon.reconstruct_rows(form, delta, refoff, geom=geom), MIXED_REPS),
        cuda_ms(lambda: [recon.reconstruct_rows(*one, width=w) for one, w in cut], MIXED_REPS))
    print(f"[mixed] config 4's first device batch, {len(shapes)} images {sorted(geom.widths)} wide "
          f"({geom.n_max} pixels the largest): the tokenizer (3 and {C.MAX_RUN_DIGITS} digits), slot assembly and "
          f"reconstruction with the table, one counted launch each, exact image by image; ms a table launch "
          f"beside one scalar launch an image: "
          f"{json.dumps({k: [round(v, 4) for v in t] for k, t in times.items()})}; "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)


def stage_ms(marks) -> dict:
    """Per-stage milliseconds from consecutive (name, event) marks."""
    out = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def launch_counts_rise(per_batch, names) -> None:
    for name in names:
        counts = [0] + [p[name] for p in per_batch]
        check(all(b > a for a, b in zip(counts, counts[1:])),
              f"{name} was not launched in every batch: {counts}")


def phase_encode(dev, imgs, refs) -> dict:
    """64 x 512^2 images in 8 batches of 8 through encode_batch; returns the
    fused encode's per-stage ms per batch."""
    nicetpu_torch.encode_batch(imgs[:8], device=dev.type)  # warm-up, not counted
    torch.cuda.synchronize()
    stats: dict = {}
    per_batch, batch_ms, blobs = [], [], []
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, 64, 8):
        tb = time.perf_counter()
        blobs += nicetpu_torch.encode_batch(imgs[i : i + 8], device=dev.type, stats=stats)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        per_batch.append(dict(cuda_ops.LAUNCHES))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    mb = sum(im.nbytes for im in imgs) / 1e6
    print(f"[encode] 64 x 512x512 RGB8 in 8 batches of 8: {seconds:.4f} s, "
          f"{mb / seconds:.2f} MB/s encode; batch ms median {np.median(batch_ms):.3f} "
          f"max {max(batch_ms):.3f}; launches={launches}, stats={stats}")
    launch_counts_rise(per_batch, ENCODE_KERNELS)
    check(stats.get("overflow_fallbacks") == 0, f"overflow fallbacks: {stats}")
    check(blobs == refs, "an encoded blob differs from the native encoder's")
    totals: dict = {}
    for i in range(0, 64, 8):
        marks: list = []
        out = pipeline.encode_batch_fused(imgs[i : i + 8], device=dev, marks=marks)
        check(out == refs[i : i + 8], "instrumented encode differs")
        torch.cuda.synchronize()
        for k, v in stage_ms(marks).items():
            totals[k] = totals.get(k, 0.0) + v
    per = {k: round(v / 8, 4) for k, v in totals.items()}
    print(f"[encode] 64/64 blobs equal hostref.encode_native; fused encode per-stage ms per batch of 8 "
          f"(CUDA events, mean of 8): {json.dumps(per)}")
    return per


def phase_encode_big(dev, img, ref) -> None:
    nicetpu_torch.encode_batch([img], device=dev.type)  # warm-up
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    blob = nicetpu_torch.encode_batch([img], device=dev.type, stats=stats)[0]
    seconds = time.perf_counter() - t0
    check(blob == ref, "4096^2 blob differs from the native encoder's")
    check(stats.get("overflow_fallbacks") == 0, f"4096^2 overflow fallback: {stats}")
    marks: list = []
    pipeline.encode_batch_fused([img], device=dev, marks=marks)
    torch.cuda.synchronize()
    per = {k: round(v, 4) for k, v in stage_ms(marks).items()}
    print(f"[encode-big] 4096x4096 RGB8: {seconds:.4f} s, {img.nbytes / 1e6 / seconds:.2f} MB/s "
          f"encode, blob equals native; per-stage ms {json.dumps(per)}")


def instrumented_roundtrip(dev, batch, ref_blobs) -> dict:
    marks: list = []
    mark_stage(marks, "begin")
    flat = pipeline.upload_batch(batch, dev)
    mark_stage(marks, "upload")
    datas, verified = pipeline.roundtrip_batch_resident(flat, batch, marks=marks)
    torch.cuda.synchronize()
    check(datas == ref_blobs and bool(verified.all()), "instrumented round trip differs")
    return stage_ms(marks)


def phase_roundtrip(dev, imgs, refs) -> tuple[dict, list]:
    """The main path: 64 x 512^2 images in 8 batches of 8 through
    roundtrip_batch(device=dev.type)."""
    nicetpu_torch.roundtrip_batch(imgs[:8], device=dev.type)  # warm-up, not counted
    torch.cuda.synchronize()
    stats: dict = {}
    per_batch, batch_ms, blobs, verified = [], [], [], []
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, 64, 8):
        tb = time.perf_counter()
        d, v = nicetpu_torch.roundtrip_batch(imgs[i : i + 8], device=dev.type, stats=stats)
        blobs += d
        verified += v.tolist()
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        per_batch.append(dict(cuda_ops.LAUNCHES))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    mb = sum(im.nbytes for im in imgs) / 1e6
    print(f"[roundtrip] 64 x 512x512 RGB8 in 8 batches of 8: {seconds:.4f} s, "
          f"{mb / seconds:.2f} MB/s round trip; batch ms median {np.median(batch_ms):.3f} "
          f"max {max(batch_ms):.3f}; verified on the device {sum(verified)}/64; "
          f"launches={launches}; stats={stats} (retries {stats.get('retries')})")
    launch_counts_rise(per_batch, PATH_KERNELS)
    check(launches["walk_tables"] == 0, f"the round trip derived the walk tables apart: {launches}")
    check(all(verified), "an image was not verified on the device")
    check(stats.get("fallbacks") == 0 and stats.get("overflow_fallbacks") == 0, f"fallbacks: {stats}")
    check(blobs == refs, "a round-trip blob differs from the native encoder's")
    totals: dict = {}
    for i in range(0, 64, 8):
        for k, v in instrumented_roundtrip(dev, imgs[i : i + 8], refs[i : i + 8]).items():
            totals[k] = totals.get(k, 0.0) + v
    per = {k: round(v / 8, 4) for k, v in totals.items()}
    print(f"[roundtrip] 64/64 verified on the device and equal to hostref.encode_native; "
          f"per-stage ms per batch of 8 (CUDA events, mean of 8): {json.dumps(per)}")
    return launches, blobs


def phase_decode(dev, imgs, blobs) -> None:
    """Decode the 64 blobs from bytes on the card, 8 at a time."""
    nicetpu_torch.decode_batch(blobs[:8], device=dev.type)  # warm-up
    torch.cuda.synchronize()
    stats: dict = {}
    per_batch, out = [], []
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, 64, 8):
        out += nicetpu_torch.decode_batch(blobs[i : i + 8], device=dev.type, stats=stats)
        per_batch.append(dict(cuda_ops.LAUNCHES))
    seconds = time.perf_counter() - t0
    mb = sum(im.nbytes for im in imgs) / 1e6
    print(f"[decode] 64 blobs in 8 batches of 8: {seconds:.4f} s, {mb / seconds:.2f} MB/s decode; "
          f"launches={dict(cuda_ops.LAUNCHES)}; stats={stats}")
    launch_counts_rise(per_batch, DECODE_KERNELS)
    check(per_batch[-1]["walk_tables"] == 0, f"the decode derived the walk tables apart: {per_batch[-1]}")
    check(stats.get("fallbacks") == 0, f"decode fallbacks: {stats}")
    check(all(np.array_equal(o, im) for o, im in zip(out, imgs)), "a decoded image differs")
    print("[decode] 64/64 decoded arrays equal their images")


def phase_roundtrip_big(dev, img, ref) -> None:
    nicetpu_torch.roundtrip_batch([img], device=dev.type)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    datas, verified = nicetpu_torch.roundtrip_batch([img], device=dev.type, stats=stats)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(cuda_ops.LAUNCHES)
    check(datas[0] == ref, "4096^2 round-trip blob differs from the native encoder's")
    check(bool(verified[0]), f"4096^2 image not verified on the device: {stats}")
    check(stats.get("fallbacks") == 0 and stats.get("overflow_fallbacks") == 0, f"4096^2: {stats}")
    launch_counts_rise([launches], PATH_KERNELS)
    check(launches["walk_tables"] == 0, f"the 4096^2 round trip derived the walk tables apart: {launches}")
    per = {k: round(v, 4) for k, v in instrumented_roundtrip(dev, [img], [ref]).items()}
    print(f"[roundtrip-big] 4096x4096 RGB8: {seconds:.4f} s, {img.nbytes / 1e6 / seconds:.2f} MB/s "
          f"round trip, verified on the device, blob equals native, peak device memory "
          f"{peak:.2f} GiB; launches={launches}; stats={stats}; per-stage ms {json.dumps(per)}")


def phase_scheduler(dev, imgs, refs) -> None:
    """The 64 images as 8 uploaded batches of 8 through roundtrip_hybrid."""
    host = [imgs[i : i + 8] for i in range(0, 64, 8)]
    mb = sum(im.nbytes for im in imgs) / 1e6
    for gpu_threads, cpu_threads in ((1, 0), (2, 0), (1, 1), (2, 1)):
        batches = [(b, pipeline.upload_batch(b, dev)) for b in host]
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        res, stats = pipeline.roundtrip_hybrid(batches, gpu_threads=gpu_threads, cpu_threads=cpu_threads)
        seconds = time.perf_counter() - t0
        launches = dict(cuda_ops.LAUNCHES)
        print(f"[scheduler] {gpu_threads} GPU + {cpu_threads} host workers, 8 resident batches of 8: "
              f"{seconds:.4f} s, {mb / seconds:.2f} MB/s round trip; split GPU {stats['gpu_batches']} / "
              f"host {stats['cpu_batches']}; stats={stats}; launches={launches}")
        check([len(r) for r in res] == [8] * 8, "the scheduler's results are incomplete")
        check([d for r in res for d, _ in r] == refs, "a scheduler blob differs from the native encoder's")
        check(all(np.array_equal(a, im) for r, b in zip(res, host) for (_, a), im in zip(r, b)),
              "a scheduler array differs from its image")
        check(stats["gpu_batches"] + stats["cpu_batches"] == 8 and stats["gpu_batches"] >= 1,
              f"the scheduler's split does not add up: {stats}")
        check(cpu_threads > 0 or stats["gpu_batches"] == 8, f"host batches without a host worker: {stats}")
        check(stats["fallbacks"] == 0 and stats["overflow_fallbacks"] == 0, f"scheduler fallbacks: {stats}")
        check(all(launches[k] >= stats["gpu_batches"] for k in PATH_KERNELS) and launches["walk_tables"] == 0,
              f"a kernel was launched fewer times than there were GPU batches, or walk_tables at all: {launches}")
    # the thread pool: the same 64 images through Pipeline.encode_many, the
    # pool at its default width on the card (workers None) and at 1, 2 and 4
    for workers in (None, 1, 2, 4):
        with pipeline.Pipeline(workers=workers, config=RuntimeConfig(backend="cuda", batch_size=8)) as p:
            p.warmup(imgs)
            cuda_ops.reset_launches()
            stats = {}
            t0 = time.perf_counter()
            blobs = p.encode_many(imgs, stats)
            seconds = time.perf_counter() - t0
            width = p.workers
        launches = dict(cuda_ops.LAUNCHES)
        print(f"[pipeline] Pipeline(workers={workers}).encode_many, pool of {width}, 8 sub-batches of 8: "
              f"{seconds:.4f} s, {mb / seconds:.2f} MB/s encode; stats={stats}; launches={launches}")
        check(blobs == refs, "a Pipeline blob differs from the native encoder's")
        check(stats == {"overflow_fallbacks": 0}, f"Pipeline fallbacks: {stats}")
        check(launches["fold_records"] == 8, f"the Pipeline's sub-batches did not run on the card: {launches}")


def phase_cli(img, ref) -> None:
    """One image through the CLI with the default backend, both ways."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("[cli] PIL is absent: api.encode / api.decode with the cuda backend instead")
        cfg = RuntimeConfig(backend="cuda")
        data = nicetpu_torch.encode(img, config=cfg)
        check(data == ref, "api.encode(config=cuda) differs from the native encoder's")
        check(np.array_equal(nicetpu_torch.decode(data, config=cfg), img), "api.decode(config=cuda) differs")
        return
    check(RuntimeConfig.from_env().backend == "cuda", "the CLI's default backend is not the card")
    cuda_ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        png, nice, back = (os.path.join(tmp, n) for n in ("in.png", "out.nice", "back.png"))
        nicetpu_torch.imwrite(png, img)
        check(cli.main([png, nice, "--verbose"]) == 0, "the CLI's encode failed")
        with open(nice, "rb") as f:
            check(f.read() == ref, "the CLI's .nice differs from the native encoder's")
        check(cli.main([nice, back]) == 0, "the CLI's decode failed")
        check(np.array_equal(nicetpu_torch.imread(back), img), "the CLI's PNG differs from the image")
    launches = dict(cuda_ops.LAUNCHES)
    check(all(launches[k] >= 1 for k in HOST_TABLE_KERNELS), f"the CLI did not run on the card: {launches}")
    print(f"[cli] .png -> .nice -> .png on the card: bytes equal hostref.encode_native, pixels equal; "
          f"launches={launches}")


SHARDS = 4  # ranks of phase 10
WIDE_W = 5000  # a width past one block's shared memory: a cluster a chain
SCRATCH_W = 70_000  # a width past a 16-CTA cluster's shared memory: device-memory scratch
SHARDED_TIMEOUT = 420.0  # seconds phase 10's spawned ranks may take in all


def shard_slices(data: bytes, nlc: int, chunk_bits: int, dev):
    """The 4 ranks' word slices of a blob and the unsharded words they cut."""
    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    slices = [torch.from_numpy(sharded_decode.shard_words(payload, d, nlc, chunk_bits).view(np.int32))
              for d in range(SHARDS)]
    wpc = chunk_bits // 32
    full = torch.cat([s[: nlc * wpc] for s in slices] + [slices[-1][nlc * wpc :]])
    return [s[None].to(dev) for s in slices], full[None].to(dev)


def sharded_walk_check(dev, data: bytes, cfg, what: str, plain: bool) -> tuple:
    """The final round over a blob's words as SHARDS shard-local walks,
    each re-based to its slice's first bit (`sharded_decode.shard_walk`),
    against the unsharded walk for the same entries with the positions
    shifted (and, where plain, each shard against walk_plain).  Returns the
    unsharded final round and its tables for the reconstruction check."""
    (_, wbits, af, pr, ib, pfx, sym_tbl), _ = decode3.prepare_batch_args([data], device=dev)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    total = int(wbits[0])
    nlc, steps = sharded_decode.shard_geometry(total, SHARDS, cfg)
    slices, full = shard_slices(data, nlc, cfg.chunk_bits, dev)
    kw = dict(chunk_bits=cfg.chunk_bits, steps=steps)
    e = (torch.arange(SHARDS * nlc, dtype=torch.int32, device=dev) * cfg.chunk_bits)[None]
    ex = decode3.walk(full, e, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
    e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1).contiguous()
    whole = decode3.walk(full, e, aff, dD, inc, pfx, wbits, **kw)
    span = nlc * cfg.chunk_bits
    for d, sl in enumerate(slices):
        c0, base = d * nlc, d * span
        ed = e[:, c0 : c0 + nlc].to(torch.int64)
        recs, exits = sharded_decode.shard_walk(sl, ed, (aff, dD, inc, pfx), total, base=base,
                                                span=span, **kw)
        pos_w = whole[0][:, c0 : c0 + nlc]
        want = (torch.where(pos_w >= 0, pos_w - base, -1), *(r[:, c0 : c0 + nlc] for r in whole[1:4]),
                whole[4][:, c0 : c0 + nlc].to(torch.int64))
        check(all(torch.equal(g, w) for g, w in zip((*recs, exits), want)),
              f"shard {d}'s re-based walk differs from the unsharded walk ({what})")
        if plain:
            rel = (ed - base).to(torch.int32).contiguous()
            wb_rel = torch.tensor([min(total - base, span)], dtype=torch.int32, device=dev)
            got = decode3.walk(sl, rel, aff, dD, inc, pfx, wb_rel, **kw)
            ref = decode3.walk_plain(sl, rel, aff, dD, inc, pfx, wb_rel, **kw)
            check(all(torch.equal(g, w) for g, w in zip(got, ref)),
                  f"shard {d}'s walk differs from walk_plain ({what})")
    print(f"[sharded-kernel] walk, {what}: {SHARDS} shard-local final rounds ({nlc} chunks x {steps} "
          f"steps each, positions relative to each slice) equal the unsharded walk's records and exits"
          f"{' and walk_plain' if plain else ''}")
    return whole, wbits, sym_tbl, nlc * SHARDS * steps


def chained_recon(form, delta, refoff, W: int, rows: list[int]):
    """The reconstruction as row blocks chained through prev4."""
    carry = torch.zeros(form.shape[0], 3, 4 * W, dtype=torch.int32, device=form.device)
    outs, r0 = [], 0
    for h in rows:
        cut = slice(r0 * W, (r0 + h) * W)
        out, carry = recon.reconstruct_rows(form[:, cut].contiguous(), delta[:, :, cut].contiguous(),
                                            refoff[:, cut].contiguous(), width=W, prev4=carry)
        outs.append(out)
        r0 += h
    return torch.cat(outs, dim=2)


def phase_sharded_kernels(dev, big, big_ref, blob512) -> None:
    """10(a): the walk's shard offsets and the reconstruction's carry."""
    H, W = big.shape[:2]
    whole, wbits, sym_tbl, S = sharded_walk_check(dev, big_ref, decode3.LADDER[-1],
                                                  "4096x4096 raster, 4096-bit chunks", plain=False)
    pos, sym, i12, i34, _ = whole
    bins = decode3._payload_bins(sym.view(1, S), i12.view(1, S), i34.view(1, S))
    syms = cuda_ops.value_join(bins, sym_tbl)
    geom = Geometry.uniform(W, H * W, 1, dev)
    rec, dst, _ = decode3.assemble_v3(pos.view(1, S), sym.view(1, S), *syms, wbits, geom=geom)
    form, delta, refoff = decode3.place_and_unpack(rec, dst, geom=geom)
    full = recon.reconstruct_rows(form, delta, refoff, width=W)
    check(torch.equal(full, torch.from_numpy(big.reshape(1, -1, 3)).to(dev).transpose(1, 2).to(torch.int32)),
          "the 4096x4096 reconstruction differs from the image")
    blocks = [H // SHARDS] * SHARDS
    chained = chained_recon(form, delta, refoff, W, blocks)
    check(torch.equal(chained, full), "4 chained row blocks differ from the unsharded reconstruction")
    whole_ms = cuda_ms(lambda: recon.reconstruct_rows(form, delta, refoff, width=W), 3, warmup=1)
    chain_ms = cuda_ms(lambda: chained_recon(form, delta, refoff, W, blocks), 3, warmup=1)
    print(f"[sharded-kernel] reconstruct_rows, 4096x4096 raster: {SHARDS} blocks of {blocks[0]} rows "
          f"chained through prev4 equal the unsharded kernel bit for bit; {chain_ms:.4f} ms chained, "
          f"{whole_ms:.4f} ms unsharded (CUDA events, 3 calls)")
    check(recon.cluster_ctas(WIDE_W, dev) > 1 and recon.chain_plan(SCRATCH_W, dev)[1] > 0,
          f"{WIDE_W} wide does not run on a cluster, or {SCRATCH_W} wide on device-memory scratch")
    for w_, where in ((WIDE_W, "a cluster a chain"), (SCRATCH_W, "device-memory scratch")):
        args = [t.to(dev) for t in _recon_rows.random_inputs(1, 6, w_, seed=w_)]
        check(torch.equal(chained_recon(*args, w_, [1, 2, 3]), recon.reconstruct_rows(*args, width=w_)),
              f"chained blocks at {w_} wide ({where}) differ from the unsharded kernel")
        print(f"[sharded-kernel] reconstruct_rows at {w_} wide ({where}): blocks of 1, "
              "2 and 3 rows chained through prev4 equal the unsharded kernel")
    # both kernels with their new arguments against their plain versions
    sharded_walk_check(dev, blob512, decode3.WalkCfg(2048, 32, 8, 2), "one 512x512 blob, 2048-bit chunks",
                       plain=True)
    for b_, h_, w_ in ((2, 16, W512), (1, 2, WIDE_W), (1, 2, SCRATCH_W)):
        args = [t.to(dev) for t in _recon_rows.random_inputs(b_, h_, w_, seed=w_ + 1)]
        prev4 = torch.from_numpy(np.random.default_rng(w_).integers(0, 256, (b_, 3, 4 * w_))
                                 .astype(np.int32)).to(dev)
        before = dict(cuda_ops.LAUNCHES)
        got = recon.reconstruct_rows(*args, width=w_, prev4=prev4), recon.reconstruct_rows(*args, width=w_)
        cluster = recon.cluster_ctas(w_, dev) > 1
        rose = {k: cuda_ops.LAUNCHES[k] - before[k] for k in ("reconstruct_rows", "reconstruct_rows_cluster")}
        check(rose == {"reconstruct_rows": 2, "reconstruct_rows_cluster": 2 * cluster},
              f"reconstruct_rows at width {w_} counted {rose}")
        want = decode_dev.reconstruct_rows(*args, h_ * w_, w_, prev4=prev4)
        err = max(max_abs_err(g, x) for g, x in zip(got[0], want))
        same = (all(torch.equal(g, x) for g, x in zip(got[0], want))
                and torch.equal(got[1], decode_dev.reconstruct_rows(*args, h_ * w_, w_)))
        print(f"[sharded-kernel] reconstruct_rows at {b_} x {h_} rows x {w_} "
              f"({'a cluster a chain' if cluster else 'one block a chain'}), with a random carry and with "
              f"zeros: out and tail exact={same} max_abs_err={err}")
        check(same, f"reconstruct_rows disagrees with its plain version at width {w_}")


def _sharded_rank(comm, device: str, big, big_ref, blobs, imgs) -> dict:
    """One rank of phase 10(b) and (c)."""
    import torch.distributed as dist

    from nicetpu_torch.dist.sharded import encode_sharded
    from nicetpu_torch.dist.sharded_decode import decode_batch_sharded, decode_sharded

    def timed(fn, *args, **kw):
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn(*args, device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(encode_sharded, big)  # warm-up: library load, allocator
    timed(decode_sharded, big_ref)
    es, ds, bs = {}, {}, {}
    cuda_ops.reset_launches()
    data, enc_s = timed(encode_sharded, big, stats=es)
    out, dec_s = timed(decode_sharded, data, stats=ds)
    launches = dict(cuda_ops.LAUNCHES)
    arrs, batch_s = timed(decode_batch_sharded, blobs, stats=bs)
    return {"rank": comm.rank, "encode_s": enc_s, "decode_s": dec_s, "batch_s": batch_s,
            "bytes_equal": data == big_ref, "raster_equal": bool(np.array_equal(out, big)),
            "batch_equal": all(np.array_equal(a, im) for a, im in zip(arrs, imgs)),
            "encode_stats": es, "decode_stats": ds, "batch_stats": bs, "launches": launches}


def phase_sharded(dev, big, big_ref, imgs, blobs) -> dict:
    """10: the sharded codec on the card.  Returns rank 0's launch counts of
    encode_sharded and decode_sharded."""
    t_phase = time.perf_counter()
    phase_sharded_kernels(dev, big, big_ref, blobs[0])
    left = SHARDED_TIMEOUT - (time.perf_counter() - t_phase)
    t0 = time.perf_counter()
    res = launch.run(_sharded_rank, SHARDS, backend="gloo", device=dev.type,
                     args=(dev.type, big, big_ref, blobs[:8], imgs[:8]), timeout=left)
    wall = time.perf_counter() - t0
    mb = big.nbytes / 1e6
    enc_s = max(r["encode_s"] for r in res)
    dec_s = max(r["decode_s"] for r in res)
    print(f"[sharded] 4096x4096 RGB8 over {SHARDS} gloo ranks on one card ({card_line()}; the "
          f"ranks' contexts time-slice one GPU and gloo stages every collective through host "
          f"memory, so this says nothing of scaling across chips): encode_sharded {enc_s:.4f} s "
          f"({mb / enc_s:.2f} MB/s), decode_sharded {dec_s:.4f} s ({mb / dec_s:.2f} MB/s); spawn, "
          f"warm-up and batch phase {wall:.1f} s")
    for r in res:
        stages = {f"{side}.{k}": round(v * 1e3, 1) for side in ("encode", "decode")
                  for k, v in r[f"{side}_stats"]["stages"].items()}
        print(f"[sharded] rank {r['rank']}: stage ms (host clock, no device wait) "
              f"{json.dumps(stages)}; launches={r['launches']}")
    for r in res:
        check(r["bytes_equal"], f"rank {r['rank']}: sharded bytes differ from hostref.encode_native")
        check(r["raster_equal"], f"rank {r['rank']}: the sharded decode differs from the image")
        check(r["encode_stats"]["overflow_fallbacks"] == 0 and r["decode_stats"]["fallbacks"] == 0,
              f"rank {r['rank']}: sharded fallbacks {r['encode_stats']} {r['decode_stats']}")
        check(all(r["launches"][k] >= 1 for k in SHARDED_KERNELS) and r["launches"]["walk_tables"] == 0,
              f"rank {r['rank']} did not launch every kernel on the sharded path, or walk_tables: {r['launches']}")
        check(r["launches"]["stitch"] == (r["rank"] == 0),
              f"rank {r['rank']}: the stitch ran {r['launches']['stitch']} times (rank 0 alone stitches, once)")
        check(r["batch_equal"] and r["batch_stats"] == {"retries": 0, "fallbacks": 0},
              f"rank {r['rank']}: decode_batch_sharded differs or fell back: {r['batch_stats']}")
    print(f"[sharded] every rank: bytes equal hostref.encode_native, raster exact, 0 fallbacks, "
          f"all nine path kernels launched, walk_tables never; decode_batch_sharded of 8 512x512 blobs over {SHARDS} ranks "
          f"exact in {max(r['batch_s'] for r in res):.4f} s")
    rank0_launches = res[0]["launches"]
    left = SHARDED_TIMEOUT - (time.perf_counter() - t_phase)
    res = launch.dryrun_multichip(1, "nccl", "cuda", timeout=left)
    check(all(res[0]["launches"][k] >= 1 for k in SHARDED_KERNELS + ("stitch",)),
          f"the NCCL dry run skipped a kernel: {res}")
    print(f"[sharded] dryrun_multichip(1, 'nccl', 'cuda'): exact, launches={res[0]['launches']}; "
          f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return rank0_launches


# phase 11's synthetic configs of bench_all and their repeats (configs 2, 4
# and 3's real photo run in phase 13)
BENCH_ALL_SYNTHETIC = ((bench_all.config1, 2), (bench_all.config3_raster, 1))
LARGE_TIMEOUT = 600.0  # seconds phase 12's spawned ranks may take in all


def bench_line_ok(line: dict) -> None:
    counts = [line] if "counts" not in line else list(line["counts"].values())
    check(all(c.get("fallbacks", 0) == 0 and c.get("overflow_fallbacks", 0) == 0 for c in counts),
          f"a bench section fell back: {line}")
    check(line.get("verified", True) and line.get("verified_on_device", True), f"unverified: {line}")
    check(not line.get("degraded", False), f"degraded bench line: {line}")


def phase_bench(dev) -> None:
    """11: the three bench modules on the card."""
    t0 = time.perf_counter()
    card = card_line()
    line = bench.run(dev.type, reps=2, card=card)
    print(json.dumps(line), flush=True)
    bench_line_ok(line)
    check(line["value"] is not None and line["gpu_share"] > 0, f"the device did no hybrid work: {line}")
    sweep = bench.hybrid_sweep(dev.type, card=card)
    print(json.dumps(sweep), flush=True)
    check(not sweep["degraded"] and all(min(r["gpu_batches"]) > 0 for r in sweep["by_gpu_threads"].values()),
          f"the GPU-worker sweep fell back or left the device idle: {sweep}")
    for config, reps in BENCH_ALL_SYNTHETIC:
        for ln in config(dev, card=card, reps=reps):
            print(json.dumps(ln), flush=True)
            bench_line_ok(ln)
    tr = bench_trace.run(dev.type, card=card)
    print(json.dumps(tr), flush=True)
    check(tr["device_ops"] > 0 and 0 <= tr["device_idle_share"] < 1, f"the trace saw no device work: {tr}")
    print(f"[bench] bench, its GPU-worker sweep, bench_all 1 and 3 (4096x4096) and bench_trace on the card: "
          f"exact, 0 fallbacks, not degraded; phase 11 took {time.perf_counter() - t0:.1f} s")


def phase_large(dev) -> None:
    """12: a payload past 2**31 bits, sharded on the device and routed to
    the host by the single-device decode."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    line, img, ref = bench_all.config5_run(dev, card=card_line(), timeout=LARGE_TIMEOUT)
    print(json.dumps(line), flush=True)
    check(line["payload_bits"] > 2**31, f"config 5's payload has {line['payload_bits']} bits")
    bench_line_ok(line)
    for r in line["ranks"]:
        print(f"[large] rank {r['rank']}: encode {r['encode_s']:.4f} s, decode {r['decode_s']:.4f} s, "
              f"peak device GiB encode {r['encode_peak_device_gib']:.2f} decode "
              f"{r['decode_peak_device_gib']:.2f}, peak RSS {r['peak_rss_gib']:.2f} GiB")
    t1 = time.perf_counter()
    stats: dict = {}
    out = nicetpu_torch.decode_batch([ref], device=dev.type, stats=stats)[0]
    host_s = time.perf_counter() - t1
    check(stats["fallbacks"] == 1, f"the single-device decode of {line['payload_bits']} bits: {stats}")
    check(np.array_equal(out, img), "the host route's raster differs")
    print(f"[large] {line['payload_bits']} payload bits: sharded on the device over 4 ranks, exact, "
          f"0 fallbacks (encode {line['encode_mbs']:.2f} MB/s, decode {line['decode_mbs']:.2f} MB/s); "
          f"decode_batch on the card sent it to the host (fallbacks 1) in {host_s:.1f} s, exact; "
          f"phase 12 took {time.perf_counter() - t0:.1f} s")


def phase_real(dev) -> None:
    """13: the real-photo corpus at full size on the card."""
    t0 = time.perf_counter()
    corpus = realcorpus.load_corpus()
    refs = [realcorpus.read_bytes(name) for name, _ in corpus]
    nicetpu_torch.roundtrip_batch([corpus[0][1]], device=dev.type)  # warm-up
    totals: dict = {}
    for (name, img), ref in zip(corpus, refs):
        stats: dict = {}
        cuda_ops.reset_launches()
        datas, verified = nicetpu_torch.roundtrip_batch([img], device=dev.type, stats=stats)
        launches = dict(cuda_ops.LAUNCHES)
        check(datas[0] == ref, f"{name}: the round trip's bytes differ from the committed file")
        check(bool(verified[0]) or stats["fallbacks"] + stats["overflow_fallbacks"] == 1,
              f"{name}: neither verified on the device nor counted: {stats}")
        if not stats["overflow_fallbacks"]:
            check(all(launches[k] >= 1 for k in PATH_KERNELS), f"{name} skipped a kernel: {launches}")
        failed = [{"rung": r["rung"], "gates": r["gates"]} for r in rung_probe.single_device(dev, img, ref)
                  if not all(r["gates"].values())]
        for k in ("retries", "fallbacks", "overflow_fallbacks"):
            totals[k] = totals.get(k, 0) + stats[k]
        print(f"[real] {name} {img.shape[0]}x{img.shape[1]}: ratio {img.nbytes / len(ref):.3f}, verified "
              f"on the device {bool(verified[0])}, retries {stats['retries']}, fallbacks "
              f"{stats['fallbacks']}, overflow_fallbacks {stats['overflow_fallbacks']}; rungs that "
              f"failed (decode from the bytes): {json.dumps(failed)}; launches={launches}", flush=True)
    # where the time goes on real content: each image's round trip with
    # stage marks, and soccer0's decode from bytes rung by rung
    for name, img in corpus:
        marks: list = []
        mark_stage(marks, "begin")
        flat = pipeline.upload_batch([img], dev)
        mark_stage(marks, "upload")
        pipeline.roundtrip_batch_resident(flat, [img], marks=marks)
        torch.cuda.synchronize()
        per = {k: round(v, 3) for k, v in stage_ms(marks).items()}
        print(f"[real] {name}: round-trip stage ms (CUDA events) {json.dumps(per)}", flush=True)
    soccer = refs[realcorpus.NAMES.index("soccer0")]
    args, (H, W) = decode3.prepare_batch_args([soccer], device=dev)
    for rung, cfg in enumerate(decode3.LADDER):
        marks = []
        mark_stage(marks, "begin")
        _, ok, _ = decode3._decode_core_v3(*args, geom=Geometry.uniform(W, H * W, 1, dev),
                                           chunk_bits=cfg.chunk_bits,
                                           steps=decode3._steps(cfg.chunk_bits, cfg.steps_div),
                                           rounds=cfg.rounds, marks=marks)
        torch.cuda.synchronize()
        per = {k: round(v, 3) for k, v in stage_ms(marks).items()}
        print(f"[real] soccer0 decode from bytes, rung {rung} {tuple(cfg)}: ok {bool(ok[0])}, stage ms "
              f"(CUDA events) {json.dumps(per)}", flush=True)
    stats = {}
    out = nicetpu_torch.decode_batch(refs, device=dev.type, stats=stats)
    check(all(np.array_equal(o, img) for o, (_, img) in zip(out, corpus)), "a corpus decode differs")
    print(f"[real] the 8 committed files through decode_batch on the card: exact; stats={stats}; round "
          f"trips: {totals}", flush=True)
    card = card_line()
    for ln in bench_real.run(dev.type, card=card, reps=2)[:-1]:
        check(ln.get("bits_match", True), f"bench_real: {ln['image']}'s totals differ")
    for config, kw in ((bench_all.config2, {"reps": 2}), (bench_all.config3_real, {"reps": 2}),
                       (bench_all.config4, {"reps": 1})):
        for ln in config(dev, card=card, **kw):
            print(json.dumps(ln), flush=True)
            check(ln["verified"], f"unverified: {ln}")
    print(f"[real] phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)


SINGLE_LARGE = (8192, 16384)  # phase 14's raster: 1.57 G payload bits, below MAX_DEVICE_BITS
FUSED_LARGE = (8192, 8192)


def phase_single_large(dev) -> None:
    """14: one device decodes a stream of 1.57 G payload bits from bytes,
    and round-trips an 8192x8192 raster, within the card's memory."""
    t0 = time.perf_counter()
    img = bench_all.make_img(*SINGLE_LARGE, bench_all.CONFIG5_SEED)
    ref = oracle.encode_native(img)
    bits = decode3.payload_bits(ref)
    check(bits < decode3.MAX_DEVICE_BITS, f"{bits} payload bits are past MAX_DEVICE_BITS")
    torch.cuda.empty_cache()
    reckoned = decode3.decode_bytes(bits // 8, img.shape[0] * img.shape[1]) / 2**30
    budget = decode3.device_budget(dev) / 2**30
    bench_all.peak_reset(dev)
    stats: dict = {}
    cuda_ops.reset_launches()
    t1 = time.perf_counter()
    out = nicetpu_torch.decode_batch([ref], device=dev.type, stats=stats)[0]
    dec_s = time.perf_counter() - t1
    peak = bench_all.peak_gib(dev)
    launches = dict(cuda_ops.LAUNCHES)
    print(f"[single-large] make_img({SINGLE_LARGE[0]}, {SINGLE_LARGE[1]}, 5), {bits} payload bits, through "
          f"decode_batch on the card: {dec_s:.2f} s, peak device memory {peak:.2f} GiB (reckoned "
          f"{reckoned:.2f} GiB, budget {budget:.2f} GiB); stats={stats}; launches={launches}", flush=True)
    check(np.array_equal(out, img), "the 1.57 G-bit raster's decode differs")
    check(stats["fallbacks"] == 0 and launches["reconstruct_rows"] >= 1,
          f"the 1.57 G-bit stream was not decoded on the device: {stats}")
    del out
    torch.cuda.empty_cache()
    for r in rung_probe.single_device(dev, img, ref):
        print(f"[single-large] rung {r['rung']} {r['cfg']}: gates {r['gates']}, equal {r['equal']}, "
              f"{r['seconds']:.2f} s, peak device memory {r['peak_device_gib']:.2f} GiB", flush=True)
    del img, ref
    torch.cuda.empty_cache()
    img = bench_all.make_img(*FUSED_LARGE, bench_all.CONFIG5_SEED)
    ref = oracle.encode_native(img)
    bench_all.peak_reset(dev)
    stats = {}
    t1 = time.perf_counter()
    datas, verified = nicetpu_torch.roundtrip_batch([img], device=dev.type, stats=stats)
    rt_s = time.perf_counter() - t1
    peak = bench_all.peak_gib(dev)
    print(f"[single-large] make_img({FUSED_LARGE[0]}, {FUSED_LARGE[1]}, 5) through roundtrip_batch on the "
          f"card: {rt_s:.2f} s, verified on the device {bool(verified[0])}, peak device memory "
          f"{peak:.2f} GiB; stats={stats}; phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    check(datas[0] == ref and bool(verified[0]), f"the 8192x8192 round trip: {stats}")
    torch.cuda.empty_cache()


S11 = 5 + C.MAX_RUN_DIGITS  # token slots a pixel at the 11-digit layout
ENCODE_KERNELS = ("tokenize", "histogram", "table_join", "fold_records")
DECODE_KERNELS = ("decode_tables", "walk", "slot_assemble", "value_join", "reconstruct_rows")
FUSED_ENCODE_KERNELS = ENCODE_KERNELS + ("huffman_tables",)  # tables built on the device


def phase_twostep_kernels(dev, imgs) -> dict:
    """The histogram and the fold at the 11-digit layout: bins of the 8
    512x512 images tokenized with 11 run digits (16 slots a pixel), their
    host tables, and the fold over 128 slots a group."""
    flat = pipeline.upload_batch(imgs, dev)
    # what the batch-wide re-tokenize costs: the tokenizer and histogram at 11 digits beside 3
    tok_ms = {cap: cuda_ms(lambda: encode2.tokenize_compact(flat, width=W512, ndigits_cap=cap), 5)
              for cap in (3, C.MAX_RUN_DIGITS)}
    print(f"[twostep-kernel] tokenize_compact of {B} x {W512}x{W512}: {tok_ms[3]:.4f} ms at 3 run digits, "
          f"{tok_ms[C.MAX_RUN_DIGITS]:.4f} ms at 11 (CUDA events, 5 calls)")
    bins, _ = encode2._tokenize_core(flat, width=W512, ndigits_cap=C.MAX_RUN_DIGITS)
    check(tuple(bins.shape) == (B, N * S11), f"11-digit bins have shape {tuple(bins.shape)}")
    offs = torch.where(bins < 858, bins + 858 * torch.arange(B, device=dev)[:, None], B * 858)
    offs = offs.flatten().to(torch.int64)
    out = {"histogram": compare(
        "histogram at 16 slots a pixel", lambda: cuda_ops.histogram(bins),
        lambda: cuda_ops.histogram_plain(bins), lambda: torch.bincount(offs, minlength=B * 858 + 1),
        plain_reps=10)}
    out["histogram"].update(bound(nbytes(bins) + B * 858 * 4, bins.numel()))
    kw11 = dict(width=W512, halo=0, g0=0, n_total=N, ndigits_cap=C.MAX_RUN_DIGITS, invalid_bin=encode2.INVALID_BIN)
    out["tokenize"] = compare(
        "tokenize at 16 slots a pixel", lambda: tok.tokenize_bins(flat, **kw11),
        lambda: tok.tokenize_bins_plain(flat, **kw11))
    out["tokenize"].update(bound(nbytes(flat, *tok.tokenize_bins(flat, **kw11)), TOKENIZE_OPS_PER_PIXEL * B * N))
    counts = cuda_ops.histogram(bins).cpu().numpy()
    tables = [build_tables_host(c) for c in counts]
    len_d, codes_d = tables_from_numpy(np.stack([t[0] for t in tables]), np.stack([t[1] for t in tables]), dev)
    aob, code = cuda_ops.table_join(bins, len_d, codes_d)
    aob2, code2 = aob.view(B, MG, 8 * S11), code.view(B, MG, 8 * S11)
    out["fold_records"] = compare(
        "fold_records at 16 slots a pixel", lambda: cuda_ops.fold_records(aob2, code2),
        lambda: cuda_ops.fold_records_plain(aob2, code2))
    rec_k = cuda_ops.fold_records(aob2, code2)
    out["fold_records"].update(bound(nbytes(aob2, code2, *rec_k), FOLD_OPS_PER_SLOT * aob2.numel()))
    live = int((bins < 858).sum())
    for name, r in out.items():
        print(f"[twostep-kernel] {name} at S = {S11} ({8 * S11} slots a group; {live} of {bins.numel()} "
              f"slots hold a token): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    return out


def phase_twostep(dev, imgs, refs, fused_stage_ms: dict) -> tuple[dict, dict]:
    """15: the two-step encode of api.encode and api.encode_batch.  Returns
    (the encode kernels' launches over the 64 images, the histogram's and the
    tokenizer's and the fold's figures at 16 slots a pixel)."""
    t0 = time.perf_counter()
    lines = bench_huffman_dev.run(dev.type, card=card_line())
    check([ln["B"] for ln in lines] == [1, 4, 8], f"bench_huffman_dev ran {[ln['B'] for ln in lines]}")
    check(all(ln["fused_bits"] == ln["twostep_bits"] for ln in lines), "bench_huffman_dev: bits differ")

    nicetpu_torch.encode_batch(imgs[:8], device=dev.type)  # warm-up, not counted
    torch.cuda.synchronize()
    stats: dict = {}
    blobs: list = []
    cuda_ops.reset_launches()
    t1 = time.perf_counter()
    for i in range(0, 64, 8):
        blobs += nicetpu_torch.encode_batch(imgs[i : i + 8], device=dev.type, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = dict(cuda_ops.LAUNCHES)
    mb = sum(im.nbytes for im in imgs) / 1e6
    print(f"[twostep] 64 x 512x512 RGB8 through encode_batch: {seconds:.4f} s, {mb / seconds:.2f} MB/s; "
          f"stats={stats}; launches={launches}", flush=True)
    check(blobs == refs, "a two-step blob differs from the native encoder's")
    check(stats["overflow_fallbacks"] == 0 and stats["retokenized"] == 0 and stats["slot_mode"] == 0,
          f"the 512x512 images left the fast two-step branch: {stats}")
    check(all(launches[k] == 8 for k in ENCODE_KERNELS), f"an encode kernel missed a batch: {launches}")
    totals: dict = {}
    for i in range(0, 64, 8):
        marks: list = []
        out = encode2.encode_batch(np.stack(imgs[i : i + 8]), device=dev, marks=marks)
        check(out == refs[i : i + 8], "instrumented two-step encode differs")
        torch.cuda.synchronize()
        for k, v in stage_ms(marks).items():
            totals[k] = totals.get(k, 0.0) + v
    per = {k: round(v / 8, 4) for k, v in totals.items()}
    print(f"[twostep] 64/64 blobs equal hostref.encode_native; per-stage ms per batch of 8 (CUDA events, "
          f"mean of 8): two-step {json.dumps(per)}; fused (phase 3) {json.dumps(fused_stage_ms)}", flush=True)

    corpus = realcorpus.load_corpus()
    for name, img in corpus:
        ref = realcorpus.read_bytes(name)
        st: dict = {}
        cuda_ops.reset_launches()
        t1 = time.perf_counter()
        blob = nicetpu_torch.encode_batch([img], device=dev.type, stats=st)[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        lc = dict(cuda_ops.LAUNCHES)
        print(f"[twostep] {name} {img.shape[0]}x{img.shape[1]} through encode_batch: {ms:.1f} ms, stats={st}, "
              f"launches={ {k: lc[k] for k in ENCODE_KERNELS} }", flush=True)
        check(blob == ref, f"{name}: the two-step bytes differ from the committed file")
        check(st["overflow_fallbacks"] == 0 and all(lc[k] >= 1 for k in ENCODE_KERNELS),
              f"{name} was not encoded on the card: {st} {lc}")
        check(name != "soccer0" or st["retokenized"] >= 1, f"soccer0 was not tokenized again: {st}")

    img = bench_all.make_img(*SINGLE_LARGE, bench_all.CONFIG5_SEED)
    ref = oracle.encode_native(img)
    torch.cuda.empty_cache()
    bench_all.peak_reset(dev)
    cuda_ops.reset_launches()
    t1 = time.perf_counter()
    blob = nicetpu_torch.encode(img, device=dev.type)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t1
    peak = bench_all.peak_gib(dev)
    lc = dict(cuda_ops.LAUNCHES)
    print(f"[twostep] make_img({SINGLE_LARGE[0]}, {SINGLE_LARGE[1]}, 5), {decode3.payload_bits(ref)} payload "
          f"bits, through nicetpu_torch.encode on the card: {enc_s:.2f} s "
          f"({img.nbytes / 1e6 / enc_s:.2f} MB/s), peak device memory {peak:.2f} GiB; launches="
          f"{ {k: lc[k] for k in ENCODE_KERNELS} }", flush=True)
    check(blob == ref, "the 1.57 G-bit raster's two-step bytes differ from the native encoder's")
    check(all(lc[k] >= 1 for k in ENCODE_KERNELS), f"the raster was not encoded on the card: {lc}")
    del img, ref, blob
    torch.cuda.empty_cache()

    kernels16 = phase_twostep_kernels(dev, imgs[:B])
    print(f"[twostep] phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, kernels16


SPEC_SIDE = 64  # phase 16's spec image: its decoder is a serial Python loop


def phase_finish(dev) -> dict:
    """16: bench_profile, bench_decode_profile and bench_multihost on the
    card; the spec backend; the RGBA policy.  Returns the two profilers'
    launch counts by name."""
    t0 = time.perf_counter()
    card = card_line()
    profile_launches: dict = {}
    for name, run, kernels in (
        ("bench_profile", lambda: bench_profile.run(dev.type, card=card), FUSED_ENCODE_KERNELS),
        ("bench_decode_profile", lambda: bench_decode_profile.run(dev.type, card=card), DECODE_KERNELS),
    ):
        t1 = time.perf_counter()
        cuda_ops.reset_launches()
        run()
        lc = dict(cuda_ops.LAUNCHES)
        check(all(lc[k] >= 1 for k in kernels), f"{name} skipped a kernel: {lc}")
        profile_launches[name] = lc
        print(f"[finish] {name}: exact, launches={lc}, {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    lines = bench_multihost.run(dev.type, card=card)
    check([ln["processes"] for ln in lines] == list(bench_multihost.RANKS), f"bench_multihost: {lines}")
    for ln in lines:
        check(all(ln["launches"][k] >= 1 for k in FUSED_ENCODE_KERNELS),
              f"bench_multihost at {ln['processes']} ranks skipped a kernel: {ln['launches']}")
    print(f"[finish] bench_multihost: rank 0's bytes equal the native encoder's at 1, 2 and 4 ranks, "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    img = make_image(SPEC_SIDE, SPEC_SIDE, 16)
    ref = oracle.encode_native(img)
    spec = RuntimeConfig(backend="spec")
    t1 = time.perf_counter()
    stats: dict = {}
    blob = nicetpu_torch.encode_batch([img], config=spec, stats=stats)[0]
    check(blob == ref and stats == {"backend": "spec"}, f"the spec backend's bytes differ: {stats}")
    stats = {}
    out = nicetpu_torch.decode_batch([blob], config=spec, stats=stats)[0]
    check(np.array_equal(out, img) and stats == {"backend": "spec"}, f"the spec backend's decode differs: {stats}")
    check(nicetpu_torch.encode(img, config=spec) == ref, "api.encode with the spec backend differs")
    spec_s = time.perf_counter() - t1
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 7, np.uint8)], axis=2)
    try:
        nicetpu_torch.encode(rgba, device=dev.type, alpha="error")
        check(False, "api.encode(rgba, alpha='error') did not raise")
    except ValueError as e:
        check("alpha" in str(e), f"api.encode(rgba, alpha='error') raised {e!r}")
    check(nicetpu_torch.encode(rgba, device=dev.type) == ref, "api.encode(rgba) with alpha dropped differs")
    print(f"[finish] spec backend {SPEC_SIDE}x{SPEC_SIDE}: bytes equal the native encoder's, decode exact, "
          f"stats {{'backend': 'spec'}}, {spec_s:.2f} s; api.encode(rgba, alpha='error') raised ValueError, "
          f"alpha='drop' on the card equals the RGB bytes; phase 16 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return profile_launches


def main() -> int:
    print(card_line())
    if not torch.cuda.is_available():
        print("[card] torch.cuda.is_available() is false: nothing to run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    seconds, log = build.build()
    build.load()
    print(f"[build] nvcc build {seconds:.2f} s\n{log.strip()}")

    kernels = phase_encode_kernels(dev)
    kernels.update(phase_decode_kernels(dev))
    kernels.update(slot_assemble_kernel(dev))
    kernels.update(stitch_kernel(dev))
    kernels["reconstruct_rows"].update(recon_cluster_kernel(dev))
    phase_decode_kernels_real(dev)
    phase_mixed_kernels(dev)

    imgs = [make_image(512, 512, s) for s in range(64)]
    t0 = time.perf_counter()
    refs = [oracle.encode_native(im) for im in imgs]
    print(f"[main] native reference encodes: {time.perf_counter() - t0:.2f} s")
    big = make_image(4096, 4096, 99)
    big_ref = oracle.encode_native(big)

    fused_stage_ms = phase_encode(dev, imgs, refs)
    phase_encode_big(dev, big, big_ref)
    launches, blobs = phase_roundtrip(dev, imgs, refs)
    phase_decode(dev, imgs, blobs)
    phase_roundtrip_big(dev, big, big_ref)
    phase_scheduler(dev, imgs, refs)
    phase_cli(imgs[0], refs[0])
    sharded_launches = phase_sharded(dev, big, big_ref, imgs, refs)
    phase_bench(dev)
    phase_large(dev)
    phase_real(dev)
    phase_single_large(dev)
    twostep_launches, kernels16 = phase_twostep(dev, imgs, refs, fused_stage_ms)
    profile_launches = phase_finish(dev)

    record = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "on_main_path": name in PATH_KERNELS, **kernels[name], "twostep_launches": twostep_launches[name],
         "sharded_launches": sharded_launches[name],
         "bench_profile_launches": profile_launches["bench_profile"][name],
         "bench_decode_profile_launches": profile_launches["bench_decode_profile"][name],
         **({"at_16_slots": kernels16[name]} if name in kernels16 else {})}
        for name in REPLACES
    ]
    print(card_line())
    print(json.dumps({"kernels": record}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
