"""Sharded `.nice` encode over `torch.distributed` ranks (row blocks).

Counterpart of `nicetpu/dist/sharded.py`.  The raster is cut into
contiguous row blocks, one a rank.  Each rank:
  1. receives its 4-row halo from the previous rank (`Comm.ppermute`),
  2. finds its block's first change at g0 = rank * n_local (`first_change`,
     one launch; mode decisions depend only on input bytes, so shard-local
     tokenization composes exactly),
  3. all-gathers every shard's first change and tokenizes its block
     (`tokenize_bins`, one launch), the run of its last change ended by the
     first change of a later shard (`tail=`),
  4. counts its tokens with the histogram kernel and sums the counts over
     the ranks,
  5. builds the Huffman tables from the summed counts on its device
     (`huffman_dev.build_tables_device`: the same tables on every rank, and
     the same as the host tables, by the shared tie-break),
  6. packs its own token range: the table-join kernel, then the fold kernel,
     the bit-offset scan and the word placement of
     `encode2._fold_place_grouped_batched`.
The shards' words, trimmed to the longest shard's, go to rank 0 (the
ordered gather), where one launch of the stitch kernel
(`cuda_ops.stitch_file`) writes the whole file in the words' device memory:
the header, the shards' bit strings at their global bit offsets, the
trailer.  The file leaves the card once, as rank 0's bytes, and the bytes'
broadcast sends that tensor.  On the CPU the plain version
(`stitch_file_plain`: `stitch_payload`, then the file around it) serves.

One rank's part is `encode_rank`, from its row block on its device to rank
0's bytes: `encode_block` (the device half) then `gather_stitch` (the
ordered gather and the stitch), or the counted host route.  Its rows come
from one of two sources: each rank's own upload where every rank holds
the raster (`encode_raster`, under the SPMD entries `encode_sharded` and
`multihost.encode_multihost`), or rank 0's upload and scatter
(`ShardGroup`).  `share_bytes` gives rank 0's bytes to every rank.  Each
stage is a span "dist.<stage>" (`profiling.StageSpans`: upload, halo,
first_changes, tokenize, histogram_psum, tables, pack, gather_words,
stitch, bytes_broadcast), timed without a device sync.

Divergences from the JAX package, on purpose: the word capacity a shard
(2 * n_local + 64, JAX's) is not asserted; totals are int64; and any
overflow flag on any rank (run digits, code length, group record,
capacity, total) sends the whole raster to `hostref.encode_native`,
counted in stats["overflow_fallbacks"].
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch.config import resolve_device
from nicetpu_torch.dist.comm import Comm, RankCall
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels.encode2 import _fold_place_grouped_batched, total_bits_overflow
from nicetpu_torch.kernels.huffman_dev import build_tables_device
from nicetpu_torch.kernels.tokenize import first_change, halo_pixels, tokenize_bins


def stitch_payload(shard_words: np.ndarray, shard_bits: np.ndarray, n_dev: int) -> tuple[bytes, int]:
    """Host-side ordered gather: concatenate per-shard bitstreams at their
    global bit offsets (exclusive scan of shard totals).  The port's copy of
    `nicetpu.dist.sharded.stitch_payload`."""
    words_per = shard_words.shape[0] // n_dev
    if int(shard_bits.max()) > 32 * words_per:
        raise ValueError(
            "shard payload exceeded its word capacity; re-run with a larger "
            "w_cap (pathological bits/pixel)"
        )
    total_bits = int(shard_bits.sum())
    out = np.zeros((total_bits + 31) // 32 + 2, dtype=np.uint64)
    base = 0
    for d in range(n_dev):
        bits = int(shard_bits[d])
        if bits == 0:
            continue
        w = shard_words[d * words_per : d * words_per + (bits + 31) // 32].astype(
            np.uint64
        )
        sw, sb = base >> 5, base & 31
        if sb == 0:
            out[sw : sw + len(w)] |= w
        else:
            out[sw : sw + len(w)] |= w >> sb
            out[sw + 1 : sw + 1 + len(w)] |= (w << (32 - sb)) & 0xFFFFFFFF
        base += bits
    return out.astype(np.uint32).astype(">u4").tobytes(), total_bits


def splits(height: int, width: int, n: int) -> bool:
    """Whether a raster splits into row blocks of at least 4 rows over n
    ranks (the halo of 4 rows must come from one previous rank), at least
    MIN_WIDTH wide."""
    return width >= C.MIN_WIDTH and height % n == 0 and height // n >= 4


def rows_per_rank(height: int, width: int, n: int) -> int:
    """Rows of each rank's block; raises where the raster cannot be split."""
    if width < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    if not splits(height, width, n):
        raise ValueError(f"height {height} must split into blocks of >= 4 rows over {n} ranks")
    return height // n


def _tokenize_block(call: RankCall, x, *, width: int):
    """x (n_local, 3) uint8, this rank's rows -> flat bins (1, n_local * S)
    with 858 holes, and the run-digit overflow flag (1,)."""
    comm, stages = call.comm, call.stages
    n_local = x.shape[0]
    N = comm.size * n_local
    halo = halo_pixels(width)
    with stages.stage("halo"):
        # the previous rank's last 4 rows (zeros on rank 0, whose halo reads
        # the cascade masks by position)
        x_ext = torch.cat([comm.ppermute(x[n_local - halo :]), x], dim=0)[None]
    kw = dict(halo=halo, g0=comm.rank * n_local, n_total=N)
    with stages.stage("first_changes"):
        # every shard's first change (N if it is all run); the run of this
        # shard's last change ends at the first change of a later shard
        firsts = comm.all_gather(first_change(x_ext, **kw))[:, 0]
    with stages.stage("tokenize"):
        return tokenize_bins(x_ext, width=width, ndigits_cap=C.MAX_RUN_DIGITS,
                             invalid_bin=C.TOTAL_SYMBOLS, tail=firsts[comm.rank + 1 :], **kw)


def encode_block(call: RankCall, x: torch.Tensor, *, width: int):
    """The device half on one rank, from its row block x (n_local, 3) uint8
    on its device: tokenize, count, tables, pack.

    Returns (words (k_max,) int32 bit patterns of this shard's payload, the
    shard bit totals (n,) int64 numpy, the flat code lengths (858,) numpy),
    or None on every rank where any rank overflowed."""
    comm, stages = call.comm, call.stages
    n_local = x.shape[0]
    bins, run_ovf = _tokenize_block(call, x, width=width)
    with stages.stage("histogram_psum"):
        counts = comm.psum(cuda_ops.histogram(bins).to(torch.int64))
    with stages.stage("tables"):
        lengths, codes, len_ovf = build_tables_device(counts)
    with stages.stage("pack"):
        S = bins.shape[1] // n_local
        aob, code = cuda_ops.table_join(bins, lengths, codes)
        w_cap = 2 * n_local + 64  # JAX's capacity, flagged here instead of asserted
        words, totals, fold_ovf = _fold_place_grouped_batched(
            aob.view(1, n_local, S), code.view(1, n_local, S), w_cap=w_cap
        )
        ovf = run_ovf | len_ovf | fold_ovf | (totals > 32 * (w_cap - 2)) | total_bits_overflow(totals)
        # one all-gather of [bits, overflow, needed bits]: the code lengths
        # times the summed counts, which the stitched total must equal
        needed = (counts * lengths.to(torch.int64)).sum()
        small = comm.all_gather(torch.stack([totals[0], ovf[0].to(torch.int64), needed]))
        if bool(small[:, 1].any()):
            return None
        bits = small[:, 0].cpu().numpy()
    if int(bits.sum()) != int(small[0, 2]):
        raise RuntimeError(f"stitched payload of {int(bits.sum())} bits, tables need {int(small[0, 2])}")
    k_max = int(min(w_cap, (int(bits.max()) + 31) // 32 + 1))
    return words[0, :k_max].contiguous(), bits, lengths[0].cpu().numpy()


def gather_stitch(call: RankCall, shard, *, height: int,
                  width: int) -> tuple[bytes | None, torch.Tensor | None]:
    """The ordered gather of `encode_block`'s result to rank 0, bounded by
    k_max words a shard, and the stitch there (`cuda_ops.stitch_file`).
    Returns, on rank 0, the `.nice` bytes (one copy of the file to the
    host, through the rank's pinned staging buffer) and the file as a uint8
    tensor on the words' device (the kernel's output on a card); (None,
    None) elsewhere.  The gathered words are freed before the copy."""
    words, bits, lengths = shard
    with call.stages.stage("gather_words"):
        shards = call.comm.gather_root(words)
    with call.stages.stage("stitch"):
        if shards is None:
            return None, None
        file = cuda_ops.stitch_file(shards, bits, file_header(width, height, lengths))
        del shards
        return call.comm.staging.to_bytes(file), file


def encode_rank(call: RankCall, x: torch.Tensor, img: np.ndarray | None, height: int,
                width: int) -> tuple[bytes | None, torch.Tensor | None]:
    """One raster's encode on one rank, from its row block x on its device:
    rank 0's stitched bytes (None elsewhere) and the file tensor the stitch
    wrote, a file the kernel wrote on a card counted in "device_stitches".
    Where any rank overflowed, rank 0 encodes its raster `img` (None on the
    other ranks) with the host encoder and no tensor comes back; the route
    is counted in "overflow_fallbacks", present at 0 otherwise."""
    shard = encode_block(call, x, width=width)
    call.count("overflow_fallbacks", int(shard is None))
    if shard is None:
        return (oracle.encode_native(img) if call.root else None), None
    data, file = gather_stitch(call, shard, height=height, width=width)
    if file is not None and file.is_cuda:
        call.count("device_stitches")
    return data, file


def share_bytes(call: RankCall, data: bytes | None, file: torch.Tensor | None = None) -> bytes:
    """Rank 0's bytes on every rank: its file tensor sent where the stitch
    left one, else its bytes."""
    with call.stages.stage("bytes_broadcast"):
        return call.comm.broadcast_bytes(data, file)


def encode_raster(call: RankCall, img: np.ndarray, *, everywhere: bool) -> bytes | None:
    """Encode one raster that every rank holds across the ranks, each rank
    uploading its own rows: the bytes on every rank (everywhere=True) or on
    rank 0 only (None elsewhere).  Raises where the height does not split
    over the ranks (`rows_per_rank`)."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    H, W, _ = img.shape
    rows = rows_per_rank(H, W, call.comm.size)
    with call.stages.stage("upload"):
        block = np.ascontiguousarray(img[call.comm.rank * rows : (call.comm.rank + 1) * rows])
        x = torch.from_numpy(block.reshape(rows * W, 3)).to(call.device)
    data, file = encode_rank(call, x, img, H, W)
    return share_bytes(call, data, file) if everywhere else data


def file_header(width: int, height: int, lengths: np.ndarray) -> bytes:
    """The header of an RGB file: file header, then the stream headers of
    the flat (858,) code lengths."""
    return headers.pack_file_header(width, height, 3) + headers.pack_stream_headers(lengths.astype(np.uint8))


def _file_bytes(header: bytes, payload: bytes, total_bits: int) -> bytes:
    """The file around `stitch_payload`'s result: the header, the payload's
    whole bytes and the trailer [B, B, 0, 0, 0]."""
    n_bytes = total_bits // 8
    B = payload[n_bytes] if total_bits % 8 else 0
    return header + payload[:n_bytes] + bytes([B, B, 0, 0, 0])


def stitch_file_plain(words: torch.Tensor, bits: np.ndarray, header: bytes) -> torch.Tensor:
    """The plain version of `cuda_ops.stitch_file` on a CPU (n, k) int32
    tensor: `stitch_payload` and `_file_bytes`, as a uint8 tensor."""
    payload, total_bits = stitch_payload(words.numpy().view(np.uint32).reshape(-1), bits, words.shape[0])
    return torch.frombuffer(bytearray(_file_bytes(header, payload, total_bits)), dtype=torch.uint8)


def encode_sharded(img: np.ndarray, *, device="cuda", group=None, stats: dict | None = None) -> bytes:
    """Encode an (H, W, 3) uint8 raster across the ranks of `group` (the
    default group if None): call it on every rank with the same raster.
    Every rank returns the `.nice` bytes, equal to `hostref.encode_native`'s.

    device: "cuda" (the rank's current CUDA device; raises without CUDA) or
    "cpu" (the kernels' plain versions).  stats: optional dict; receives
    "overflow_fallbacks" (1 when the raster went to the host encoder),
    "device_stitches" (1 on rank 0 when the stitch kernel wrote the file on
    its card) and "stages" (this rank's host seconds per stage, the spans
    "dist.<stage>"; nothing waits for the device)."""
    return encode_raster(RankCall(Comm(group), resolve_device(device), stats), img, everywhere=True)
