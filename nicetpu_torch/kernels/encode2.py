"""Batched device encode in PyTorch: tokenize, histogram, Huffman tables,
table join, group-record fold, bit-offset scan and word placement.

Counterpart of `nicetpu/kernels/encode2.py`, with the same outputs bit for
bit.  Two paths, as in the JAX package:
  * the two-step encode of `api.encode`/`api.encode_batch` (`encode_batch`,
    `encode_v2`): `tokenize_compact` (tokenizer + histogram), one fetch of
    the counts, Huffman tables built on the host (`build_tables_host`),
    then `pack_compact` (table join, then the grouped fold and place, or the
    exact slot-level `_place` where a group record passes 320 bits).  It
    keeps every image on the device: a run of more than 512 pixels
    re-tokenizes the batch with all 11 run digits;
  * the fused encode of the schedulers and the round trip (`encode_fused`,
    `encode_fused_core`): tables built on the device (`huffman_dev`), no
    host round trip, and an overflow flag where the caller must take an
    exact host path.
Tokenizer, histogram, join and fold run as the CUDA kernels of `cuda_ops`
on a CUDA tensor and as their plain versions on a CPU tensor.

uint32 values (codes, records, payload words) travel as int32 bit patterns,
because torch has no uint32 arithmetic; shifts and sums that need unsigned
semantics widen to int64 first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nicetpu_torch.convert import MASK32, from_int32_bits, tables_from_numpy, to_int32_bits, words_to_numpy
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.format.huffman import build_tables_host
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels.bitpack import words_to_payload
from nicetpu_torch.kernels.huffman_dev import build_tables_device
from nicetpu_torch.kernels.geometry import Geometry
from nicetpu_torch.kernels.tokenize import tokenize_bins, tokenize_images
from nicetpu_torch.utils.profiling import mark_stage, span

INVALID_BIN = 1023  # >= 858 means "no token"
GROUP = 8  # pixels folded into one record
GROUP_CAPW = cuda_ops.FOLD_CAPW  # words per group record (320 bits)


def _tokenize_core(imgs_flat: torch.Tensor, *, width: int, ndigits_cap: int):
    """(B, N, 3) uint8 -> (bins (B, M) int32, overflow (B,) bool).

    Bins are flat histogram bins in serial slot order (M = N * slots) with
    INVALID_BIN holes; overflow says a run needs more than ndigits_cap
    base-8 digits.  On a CUDA tensor: the tokenizer kernel, one launch.
    """
    N = imgs_flat.shape[-2]
    return tokenize_bins(imgs_flat, width=width, halo=0, g0=0, n_total=N, ndigits_cap=ndigits_cap,
                         invalid_bin=INVALID_BIN)


def _fold_place_grouped_batched(aob3, code3, *, w_cap: int, marks=None):
    """Grouped fold + place: (B, N, S) per-pixel slots -> (words (B, w_cap)
    int32 bit patterns, totals (B,) int64, overflow (B,) bool).

    GROUP consecutive pixels fold into one left-aligned record (the fold
    kernel); each record lands at its exclusive-scan bit offset as capw + 1
    funnel-shifted words, summed into the payload.  Out-of-range words are
    dropped, as JAX's mode="drop" scatter does.
    """
    B, N, S = aob3.shape
    pad = (-N) % GROUP
    if pad:
        aob3 = F.pad(aob3, (0, 0, 0, pad))
        code3 = F.pad(code3, (0, 0, 0, pad))
    Mg = aob3.shape[1] // GROUP
    capw = GROUP_CAPW
    with span("encode2.fold", marks):
        rec, k = cuda_ops.fold_records(
            aob3.reshape(B, Mg, GROUP * S), code3.reshape(B, Mg, GROUP * S)
        )  # rec (B, capw, Mg) int32 bit patterns; k (B, Mg) int32
        overflow = (k > 32 * capw).any(dim=1)

    with span("encode2.place", marks):
        incl = torch.cumsum(k, dim=1, dtype=torch.int64)
        totals = incl[:, -1]
        offs = incl - k
        w = offs >> 5
        r = offs & 31
        recu = from_int32_bits(rec)
        zero = torch.zeros_like(offs)
        words = torch.zeros(B, w_cap, dtype=torch.int64, device=k.device)
        for j in range(capw + 1):
            cur = recu[:, j] if j < capw else zero
            prev = recu[:, j - 1] if j > 0 else zero
            val = (cur >> r) | torch.where(r > 0, (prev << (32 - r)) & MASK32, 0)
            idx = w + j
            keep = idx < w_cap
            words.scatter_add_(1, torch.where(keep, idx, 0), torch.where(keep, val, 0))
    return to_int32_bits(words & MASK32), totals, overflow


def encode_fused_core(imgs_flat, *, geom: Geometry, ndigits_cap: int, w_cap: int, marks=None):
    """Tokenize + histogram + Huffman tables + join + fold + place.

    imgs_flat: (B, N, 3) uint8, images of any shapes, each zero past its
    own pixels; geom: their `geometry.Geometry` (N the largest image's).
    Each image's bins, tables and payload are its own alone.  Returns
    (words (B, w_cap) int32 bit patterns, lengths (B, 858) int32, totals
    (B,) int64, ovf (B,) bool).
    ovf is set for a run over ndigits_cap digits, a code over 31 bits, a
    group record over 320 bits, a payload over w_cap words, or a total of
    2**31 bits or more.
    marks: optional list; when given, a CUDA event is recorded after each
    stage and appended as (stage name, event).
    """
    with span("encode2.tokenize", marks):
        bins, run_ovf = tokenize_images(imgs_flat, geom=geom, ndigits_cap=ndigits_cap, invalid_bin=INVALID_BIN)
    with span("encode2.histogram", marks):
        counts = cuda_ops.histogram(bins)
    with span("encode2.huffman_build", marks):
        lengths, codes, len_ovf = build_tables_device(counts)
    with span("encode2.join", marks):
        aob, code = cuda_ops.table_join(bins, lengths, codes)

    B, M = aob.shape
    slots = M // imgs_flat.shape[1]
    words, totals, fold_ovf = _fold_place_grouped_batched(
        aob.view(B, M // slots, slots),
        code.view(B, M // slots, slots),
        w_cap=w_cap,
        marks=marks,
    )

    cap_ovf = totals > 32 * (w_cap - 2)
    ovf = run_ovf | len_ovf | fold_ovf | cap_ovf | total_bits_overflow(totals)
    return words, lengths, totals, ovf


def total_bits_overflow(totals: torch.Tensor) -> torch.Tensor:
    """(B,) int64 payload bit totals -> (B,) bool: the total does not fit
    the int32 slot of the (B, 860) small array.  Where w_cap allows payloads
    of 2**31 bits or more (rasters from about 77 M pixels), such an image
    takes the exact host path instead of carrying a wrapped total."""
    return totals >= 2**31


def encode_fused(imgs_flat, *, geom: Geometry, ndigits_cap: int, w_cap: int, marks=None):
    """Whole encode of a (B, N, 3) uint8 batch of `geom`'s images.

    Returns (words (B, w_cap) int32 bit patterns of the uint32 payload
    words, small (B, 860) int32) where small = per-image [flat code lengths
    (858), total payload bits, overflow flag] — the layout of the JAX
    `encode_fused`.  When the overflow flag is set the caller must encode
    that image on an exact host path.
    """
    words, lengths, totals, ovf = encode_fused_core(
        imgs_flat, geom=geom, ndigits_cap=ndigits_cap, w_cap=w_cap, marks=marks
    )
    small = torch.cat(
        [lengths, totals.to(torch.int32)[:, None], ovf.to(torch.int32)[:, None]], dim=1
    )
    return words, small


# ---------------------------------------------------------------------------
# the two-step encode of api.encode / api.encode_batch: tokenize + histogram,
# host tables, then join + fold + place
# ---------------------------------------------------------------------------

PLACE_BLOCK = 1 << 26  # slots `_place` shifts at a time: bounds its int64 temporaries


def tokenize_compact(imgs_flat: torch.Tensor, *, width: int, ndigits_cap: int):
    """Dispatch A of the two-step encode: (B, N, 3) uint8 -> (bins (B, M)
    int32 in serial slot order with INVALID_BIN holes, stats (B, 859) int32)
    where stats is each image's histogram (858) and its overflow flag (a run
    needs more than ndigits_cap base-8 digits)."""
    bins, overflow = _tokenize_core(imgs_flat, width=width, ndigits_cap=ndigits_cap)
    counts = cuda_ops.histogram(bins)
    return bins, torch.cat([counts, overflow.to(torch.int32)[:, None]], dim=1)


def _place(aob: torch.Tensor, code: torch.Tensor, *, w_cap: int):
    """Exact slot-level placement of one image: (M,) int32 code lengths and
    code bit patterns -> (words (w_cap,) int32 bit patterns, total bits, a
    0-d int64 tensor).

    Each slot's code lands at its exclusive-scan bit offset as two words
    (what fits in the offset's word, and the rest at the top of the next),
    summed into the payload; words past w_cap are dropped.  The offsets come
    from one int64 cumsum (the TPU's triangular-matmul scan has no place
    here), so a payload of 2**31 bits or more places exactly; the shifts run
    PLACE_BLOCK slots at a time."""
    incl = torch.cumsum(aob, dim=0, dtype=torch.int64)
    words = torch.zeros(w_cap, dtype=torch.int64, device=aob.device)
    for s0 in range(0, aob.shape[0], PLACE_BLOCK):
        L = aob[s0 : s0 + PLACE_BLOCK].to(torch.int64)
        offs = incl[s0 : s0 + PLACE_BLOCK] - L
        cd = from_int32_bits(code[s0 : s0 + PLACE_BLOCK])
        rb = offs & 31
        fits = rb + L <= 32
        k = torch.where(fits, 0, rb + L - 32)
        shift_hi = torch.where(fits, 32 - rb - L, k).clamp(0, 31)
        hi = torch.where(fits, (cd << shift_hi) & MASK32, cd >> shift_hi)
        mask_k = (torch.ones_like(k) << k) - 1
        lo = torch.where(fits, 0, ((cd & mask_k) << (32 - k).clamp(0, 31)) & MASK32)
        w = offs >> 5
        for idx, val in ((w, hi), (w + 1, lo)):
            keep = idx < w_cap
            words.scatter_add_(0, torch.where(keep, idx, 0), torch.where(keep, val, 0))
    return to_int32_bits(words & MASK32), incl[-1]


def pack_compact(bins, aob_tbl, code_tbl, *, w_cap: int, slots: int, mode: str = "fold", marks=None):
    """Dispatch B of the two-step encode: join each image's tables, scan the
    bit offsets, place.

    bins (B, N * slots) int32 with INVALID_BIN holes; aob_tbl (B, 858) int32
    code lengths; code_tbl (B, 858) int32 bit patterns of the uint32 codes.
    mode "fold": the grouped fold and place, which flags an image with a
    group record over 320 bits; "slots": the exact slot-level `_place`, one
    image at a time.  Returns (words (B, w_cap) int32 bit patterns, totals
    (B,) int64, overflow (B,) bool)."""
    if mode not in ("fold", "slots"):
        raise ValueError(f"unknown pack mode {mode!r}: use 'fold' or 'slots'")
    with span("encode2.join", marks):
        aob, code = cuda_ops.table_join(bins, aob_tbl, code_tbl)
    B, M = aob.shape
    if mode == "fold":
        return _fold_place_grouped_batched(
            aob.view(B, M // slots, slots), code.view(B, M // slots, slots), w_cap=w_cap, marks=marks
        )
    with span("encode2.place", marks):
        placed = [_place(aob[b], code[b], w_cap=w_cap) for b in range(B)]
    words = torch.stack([p[0] for p in placed])
    totals = torch.stack([p[1] for p in placed])
    return words, totals, torch.zeros(B, dtype=torch.bool, device=aob.device)


def _bucket(n: int, buckets=(1, 2, 3, 4, 6, 8, 12, 16)) -> int:
    """Round a size up to a stable bucket (the JAX package's word-capacity
    buckets, kept so that the words past the payload match)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def payload_capacity(needed_bits: np.ndarray, n_pixels: int) -> int:
    """The two-step encode's word capacity for a batch whose payloads need
    `needed_bits` (B,) bits: the JAX package's bucketed formula, so that the
    words past each payload are zero in both packages."""
    needed_words = int(needed_bits.max()) // 32 + 2
    N = n_pixels
    return max(_bucket(-(-needed_words * 8 // max(N, 8))) * (N // 8 + 1) + 2, needed_words + 2)


def _add(stats: dict | None, key: str, n: int) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _tokenize_counts(flat: torch.Tensor, *, width: int, ndigits_cap: int, marks=None):
    """`tokenize_compact` and one fetch of its (B, 859) stats: (bins on the
    device, int64 numpy stats)."""
    with span("encode2.tokenize+histogram", marks):
        bins, st = tokenize_compact(flat, width=width, ndigits_cap=ndigits_cap)
    with span("encode2.counts_to_host", marks):
        return bins, st.cpu().numpy().astype(np.int64)


def encode_resident(flat: torch.Tensor, *, width: int, stats: dict | None = None, marks=None):
    """The two-step encode of a resident (B, N, 3) uint8 batch, up to the
    packed words.

    Returns (words (B, w_cap) int32 bit patterns on the batch's device,
    totals (B,) int64 numpy, lengths (B, 858) int32 numpy).  Where some run
    needs more than 3 base-8 digits, the whole batch is tokenized again with
    all 11 (stats["retokenized"] += B); where some group record passes 320
    bits, the batch is packed again slot by slot (stats["slot_mode"] += 1).
    Raises RuntimeError where a device total differs from the bits the host
    tables say the payload needs."""
    B, N, _ = flat.shape
    with span("encode2.encode_resident"):
        bins, counts = _tokenize_counts(flat, width=width, ndigits_cap=3, marks=marks)
        if counts[:, -1].any():
            del bins
            bins, counts = _tokenize_counts(flat, width=width, ndigits_cap=C.MAX_RUN_DIGITS, marks=marks)
            _add(stats, "retokenized", B)
        counts = counts[:, :-1]
        with span("encode2.host_tables", marks):
            with span("encode2.build_tables_host"):
                tables = [build_tables_host(c) for c in counts]
            lengths = np.stack([t[0] for t in tables]).astype(np.int32)
            codes = np.stack([t[1] for t in tables])
            needed_bits = (counts * lengths.astype(np.int64)).sum(axis=1)

        w_cap = payload_capacity(needed_bits, N)
        slots = bins.shape[1] // N
        with span("encode2.tables_to_device", marks):
            aob_tbl, code_tbl = tables_from_numpy(lengths, codes, flat.device)
        words, totals, ovf = pack_compact(bins, aob_tbl, code_tbl, w_cap=w_cap, slots=slots, marks=marks)
        if bool(ovf.any()):
            del words, totals
            words, totals, _ = pack_compact(bins, aob_tbl, code_tbl, w_cap=w_cap, slots=slots,
                                            mode="slots", marks=marks)
            _add(stats, "slot_mode", 1)
        with span("encode2.sync"):
            totals = totals.cpu().numpy()
    bad = np.flatnonzero(totals != needed_bits)
    if bad.size:
        b = int(bad[0])
        raise RuntimeError(f"image {b} of the batch: the device packed {int(totals[b])} bits, "
                           f"its tables need {int(needed_bits[b])}")
    return words, totals, lengths


def encode_batch(imgs: np.ndarray, *, device="cuda", stats: dict | None = None, marks=None) -> list[bytes]:
    """Encode a (B, H, W, 3) uint8 batch of same-shape images on `device`
    through the two-step encode, with per-image Huffman tables (the
    counterpart of the JAX `encode2.encode_batch`).

    stats: optional dict; accumulates "retokenized" and "slot_mode" (see
    `encode_resident`).  marks: optional list that receives (stage, CUDA
    event) pairs: "start", "upload", "tokenize+histogram", "counts_to_host",
    "host_tables", "tables_to_device", "join", "fold", "place" and
    "fetch+assembly"."""
    if imgs.ndim != 4 or imgs.shape[3] != 3 or imgs.dtype != np.uint8:
        raise ValueError("expected (B, H, W, 3) uint8 batch")
    B, H, W, _ = imgs.shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    with span("encode2.encode_batch"):
        mark_stage(marks, "start")
        with span("encode2.upload", marks):
            flat = torch.from_numpy(np.ascontiguousarray(imgs).reshape(B, H * W, 3)).to(device)
        words_d, totals, lengths = encode_resident(flat, width=W, stats=stats, marks=marks)
        del flat
        with span("encode2.fetch+assembly", marks):
            return assemble(words_d, totals, lengths, H, W)


def assemble(words_d: torch.Tensor, totals: np.ndarray, lengths: np.ndarray, height: int,
             width: int) -> list[bytes]:
    """`.nice` byte strings of a batch from `encode_resident`'s outputs: one
    fetch of the words the payloads need, then headers and payload bytes."""
    with span("encode2.assemble"):
        with span("encode2.fetch"):
            # words_to_payload reads at most total // 32 + 2 words of an image
            words = words_to_numpy(words_d[:, : int(totals.max()) // 32 + 2].contiguous())
        with span("encode2.bytes"):
            file_hdr = headers.pack_file_header(width, height, 3)
            return [
                file_hdr
                + headers.pack_stream_headers(lengths[b].astype(np.uint8))
                + words_to_payload(words[b], int(totals[b]))
                for b in range(len(totals))
            ]


def encode_v2(img: np.ndarray, *, device="cuda") -> bytes:
    """Encode an (H, W, 3) uint8 image through the two-step encode (a batch
    of one; the counterpart of the JAX `encode_jax_v2`)."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    return encode_batch(img[None], device=device)[0]
