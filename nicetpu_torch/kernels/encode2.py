"""Fused batched encode in PyTorch: tokenize, histogram, on-device Huffman
tables, table join, group-record fold, bit-offset scan and word placement.

Counterpart of `nicetpu/kernels/encode2.py` (`_tokenize_core`,
`_fold_place_grouped_batched`, `encode_fused_core`, `encode_fused`), with the
same outputs bit for bit.  Histogram, join and fold run as the CUDA kernels
of `cuda_ops` on a CUDA tensor and as their plain versions on a CPU tensor.

uint32 values (codes, records, payload words) travel as int32 bit patterns,
because torch has no uint32 arithmetic; shifts and sums that need unsigned
semantics widen to int64 first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nicetpu_torch.convert import MASK32, from_int32_bits, to_int32_bits
from nicetpu_torch.kernels import cuda_ops
from nicetpu_torch.kernels.huffman_dev import build_tables_device
from nicetpu_torch.kernels.scan import suffix_min
from nicetpu_torch.kernels.tokenize import assemble_bins, cascade

INVALID_BIN = 1023  # >= 858 means "no token"
GROUP = 8  # pixels folded into one record
GROUP_CAPW = cuda_ops.FOLD_CAPW  # words per group record (320 bits)


def _tokenize_core(imgs_flat: torch.Tensor, *, width: int, ndigits_cap: int):
    """(B, N, 3) uint8 -> (bins (B, M) int32, overflow (B,) bool).

    Bins are flat histogram bins in serial slot order (M = N * slots) with
    INVALID_BIN holes; overflow says a run needs more than ndigits_cap
    base-8 digits.
    """
    N = imgs_flat.shape[-2]
    x = imgs_flat.to(torch.int32)
    cas = cascade(x, 0, N, width=width, halo=0)
    pos = cas["pos"]
    change_idx = torch.where(cas["changed"], pos, N)
    sfx = suffix_min(change_idx)
    next_change = torch.cat([sfx[..., 1:], torch.full_like(sfx[..., :1], N)], dim=-1)
    run_len = next_change - pos - 1
    bins, overflow = assemble_bins(
        cas, run_len, ndigits_cap=ndigits_cap, invalid_bin=INVALID_BIN
    )
    return bins.reshape(*bins.shape[:-2], -1), overflow


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
    rec, k = cuda_ops.fold_records(
        aob3.reshape(B, Mg, GROUP * S), code3.reshape(B, Mg, GROUP * S)
    )  # rec (B, capw, Mg) int32 bit patterns; k (B, Mg) int32
    overflow = (k > 32 * capw).any(dim=1)
    mark_stage(marks, "fold")

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
    mark_stage(marks, "place")
    return to_int32_bits(words & MASK32), totals, overflow


def encode_fused_core(imgs_flat, *, width: int, ndigits_cap: int, w_cap: int, marks=None):
    """Tokenize + histogram + Huffman tables + join + fold + place.

    imgs_flat: (B, N, 3) uint8.  Returns (words (B, w_cap) int32 bit
    patterns, lengths (B, 858) int32, totals (B,) int64, ovf (B,) bool).
    ovf is set for a run over ndigits_cap digits, a code over 31 bits, a
    group record over 320 bits, a payload over w_cap words, or a total of
    2**31 bits or more.
    marks: optional list; when given, a CUDA event is recorded after each
    stage and appended as (stage name, event).
    """
    bins, run_ovf = _tokenize_core(imgs_flat, width=width, ndigits_cap=ndigits_cap)
    mark_stage(marks, "tokenize")
    counts = cuda_ops.histogram(bins)
    mark_stage(marks, "histogram")
    lengths, codes, len_ovf = build_tables_device(counts)
    mark_stage(marks, "huffman_build")
    aob, code = cuda_ops.table_join(bins, lengths, codes)
    mark_stage(marks, "join")

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


def encode_fused(imgs_flat, *, width: int, ndigits_cap: int, w_cap: int, marks=None):
    """Whole encode of a (B, N, 3) uint8 batch.

    Returns (words (B, w_cap) int32 bit patterns of the uint32 payload
    words, small (B, 860) int32) where small = per-image [flat code lengths
    (858), total payload bits, overflow flag] — the layout of the JAX
    `encode_fused`.  When the overflow flag is set the caller must encode
    that image on an exact host path.
    """
    words, lengths, totals, ovf = encode_fused_core(
        imgs_flat, width=width, ndigits_cap=ndigits_cap, w_cap=w_cap, marks=marks
    )
    small = torch.cat(
        [lengths, totals.to(torch.int32)[:, None], ovf.to(torch.int32)[:, None]], dim=1
    )
    return words, small


def mark_stage(marks, name: str) -> None:
    """Append (name, CUDA event recorded now on the current stream) to
    `marks` when it is a list; do nothing when it is None."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
