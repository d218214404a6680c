"""CUDA kernels of `pallas_ops`: wrappers, plain versions, launch counts.

Counterpart of `nicetpu/kernels/pallas_ops.py`: the encode's histogram,
table join and group-record fold (`csrc/encode_kernels.cu`) and the
decode's value join (`csrc/decode_kernels.cu`), and the fused encode's
Huffman tables (`csrc/huffman_kernels.cu`, the counterpart of JAX's jitted
`huffman_dev.build_tables_device`), the tokenizer
(`csrc/tokenize_kernels.cu`, the counterpart of JAX's jnp `_tokenize_core`;
dispatched by `tokenize.tokenize_bins`) and the decode tables
(`csrc/decode_tables_kernels.cu`, the counterparts of JAX's jnp
`prepare_tables_v3_jnp` and `derive_walk_tables`; dispatched by
`decode3.prepare_tables_v3`, which builds all ten tables in one launch,
and `decode3.derive_walk_tables` for arbitrary tables) and the decode
core's slot assembly (`csrc/slot_assemble_kernels.cu`, the counterpart of
JAX's in-layout scans `_cumsum_walk` and `_cummax_walk`), and the sharded
encode's stitch (`csrc/stitch_kernels.cu`, which stands for the host numpy
`stitch_payload` of JAX's `dist/sharded.py`; the plain version is
`dist.sharded.stitch_file_plain`).  `LAUNCHES` also counts the walk
(`decode3.walk`) and the row reconstruction (`recon.reconstruct_rows`).
Each kernel has
  * a wrapper that checks its inputs and, for a CUDA tensor, launches the
    kernel (or raises); for a CPU tensor it runs the plain version, since
    there is no kernel to launch there;
  * a plain PyTorch version of the same function (`*_plain`), which the CPU
    tests hold against the Pallas kernels and which `chip_smoke.py` holds
    against the CUDA kernel on the card;
  * a launch count in `LAUNCHES`, raised by one at each kernel launch only
    (the tokenizer's once a call of its one launch; the sharded path's
    `first_change` before it is not counted; the slot assembly's once a
    call of its three; a reconstruction on a thread-block cluster counts
    in "reconstruct_rows" and in "reconstruct_rows_cluster").

Tensors carrying uint32 values (codes, records) are int32 bit patterns.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from nicetpu_torch.format import constants as C
from nicetpu_torch.convert import MASK32, from_int32_bits, to_int32_bits
from nicetpu_torch.kernels import geometry

NSYM = C.TOTAL_SYMBOLS  # 858
FOLD_CAPW = 10  # words per group record (320 bits), as kCapw in the kernel

LAUNCHES = {
    "histogram": 0, "table_join": 0, "fold_records": 0,
    "walk": 0, "value_join": 0, "reconstruct_rows": 0, "reconstruct_rows_cluster": 0,
    "huffman_tables": 0, "tokenize": 0, "decode_tables": 0, "walk_tables": 0, "slot_assemble": 0,
    "stitch": 0,
}
_LAUNCHES_LOCK = threading.Lock()  # worker threads launch concurrently; the counts stay exact


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check(t: torch.Tensor, name: str, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")
    if t.numel() == 0:
        raise ValueError(f"{name} must not be empty")


def check_per_symbol(t: torch.Tensor, name: str, kernel: str) -> None:
    """A (B, 858) int32 or int64 tensor with B >= 1, on the CPU or a card
    (there B <= 65535, the kernel's grid)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != NSYM or t.shape[0] == 0:
        raise ValueError(f"{name} must be (B, {NSYM}) with B >= 1, got shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")
    if t.device.type == "cuda" and t.shape[0] > 65535:
        raise ValueError(f"{kernel} takes at most 65535 images")


def same_device(*ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in ts]}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def count_launch(name: str) -> None:
    """Add one to a kernel's launch count (exact under concurrent threads)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def launch(name: str | None, fn, *args, device: torch.device) -> None:
    """Call a C entry point on `device`'s current stream; raise on error.
    Counts one launch of `name` (none where name is None)."""
    from nicetpu_torch.kernels import build

    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(*args, ctypes.c_int(device.index), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.nt_error_string(err).decode()} ({err})")
    if name is not None:
        count_launch(name)


# ---------------------------------------------------------------------------
# histogram (replaces pallas_ops.histogram_pallas)
# ---------------------------------------------------------------------------


def histogram_plain(bins: torch.Tensor) -> torch.Tensor:
    """(B, M) int32 bins (holes outside [0, 858)) -> (B, 858) int32 counts."""
    live = (bins >= 0) & (bins < NSYM)
    idx = torch.where(live, bins, NSYM).to(torch.int64)
    out = torch.zeros(bins.shape[0], NSYM + 1, dtype=torch.int32, device=bins.device)
    out.scatter_add_(1, idx, torch.ones_like(bins))
    return out[:, :NSYM].contiguous()


def histogram(bins: torch.Tensor) -> torch.Tensor:
    """Per-image histogram of flat bins: (B, M) int32 -> (B, 858) int32."""
    check(bins, "bins", 2)
    if bins.device.type == "cpu":
        return histogram_plain(bins)
    B, M = bins.shape
    if B > 65535:
        raise ValueError("histogram takes at most 65535 images")
    out = torch.zeros(B, NSYM, dtype=torch.int32, device=bins.device)
    launch(
        "histogram", "nt_histogram", ptr(bins), ptr(out), ctypes.c_int(B),
        ctypes.c_longlong(M), device=bins.device,
    )
    return out


# ---------------------------------------------------------------------------
# table join (replaces pallas_ops.table_join_pallas)
# ---------------------------------------------------------------------------


def table_join_plain(bins, lengths, codes):
    """bins (B, M) int32; lengths, codes (B, 858) int32 -> (aob, code), each
    (B, M) int32; holes map to 0."""
    live = (bins >= 0) & (bins < NSYM)
    idx = torch.where(live, bins, NSYM).to(torch.int64)
    aob = F.pad(lengths, (0, 1)).gather(1, idx)
    code = F.pad(codes, (0, 1)).gather(1, idx)
    return aob, code


def table_join(bins, lengths, codes):
    """Per-image table lookup: bin -> (code length, code bit pattern)."""
    check(bins, "bins", 2)
    check(lengths, "lengths", 2)
    check(codes, "codes", 2)
    same_device(bins, lengths, codes)
    B, M = bins.shape
    if lengths.shape != (B, NSYM) or codes.shape != (B, NSYM):
        raise ValueError(f"tables must be ({B}, {NSYM})")
    if bins.device.type == "cpu":
        return table_join_plain(bins, lengths, codes)
    if B > 65535:
        raise ValueError("table_join takes at most 65535 images")
    aob = torch.empty_like(bins)
    code = torch.empty_like(bins)
    launch(
        "table_join", "nt_table_join", ptr(bins), ptr(lengths), ptr(codes), ptr(aob),
        ptr(code), ctypes.c_int(B), ctypes.c_longlong(M), device=bins.device,
    )
    return aob, code


# ---------------------------------------------------------------------------
# group-record fold (replaces pallas_ops.fold_records_pallas)
# ---------------------------------------------------------------------------


def fold_records_plain(aob2, code2):
    """aob2, code2 (B, Mg, S) int32 -> (rec (B, FOLD_CAPW, Mg) int32 bit
    patterns of the left-aligned records, k (B, Mg) int32 bit lengths).

    The arithmetic of `pallas_ops._fold_kernel` in int64, so that shifts are
    logical and nothing overflows; bits past 32*FOLD_CAPW are dropped."""
    B, Mg, S = aob2.shape
    rec = [torch.zeros(B, Mg, dtype=torch.int64, device=aob2.device) for _ in range(FOLD_CAPW)]
    cum = torch.zeros(B, Mg, dtype=torch.int64, device=aob2.device)
    for s in range(S):
        L = aob2[:, :, s].to(torch.int64)
        cd = from_int32_bits(code2[:, :, s])
        sw = cum >> 5
        sb = cum & 31
        fits = sb + L <= 32
        k = torch.where(fits, 0, sb + L - 32)
        shift_hi = torch.where(fits, 32 - sb - L, k).clamp(0, 31)
        hi = torch.where(fits, (cd << shift_hi) & MASK32, cd >> shift_hi)
        mask_k = ((torch.ones_like(k) << k.clamp(max=32)) - 1) & MASK32
        shift_lo = (32 - k).clamp(0, 31)
        lo = torch.where(fits, 0, ((cd & mask_k) << shift_lo) & MASK32)
        for j in range(min(FOLD_CAPW, s + 2)):
            upd = torch.where(sw == j, hi, 0)
            if j > 0:
                upd = upd | torch.where(sw == j - 1, lo, 0)
            rec[j] = rec[j] | upd
        cum = cum + L
    return to_int32_bits(torch.stack(rec, dim=1)), cum.to(torch.int32)


def fold_records(aob2, code2):
    """Grouped record fold: (B, Mg, S) slots -> (rec (B, FOLD_CAPW, Mg), k (B, Mg)).

    Equal to `fold_records_plain` for any codes and any lengths whose
    running sums stay inside int32 (beyond that the kernel's int32 sums
    wrap, as the Pallas kernel's do, and the plain version's int64 do not).
    The kernel folds a group through a two-word window, which holds while
    every length of the group is in 0..32 (a valid image's are at most 31);
    a group with any other length is folded again, in the same launch, by
    the kernel's generic ten-word fold: such input is slower, not different,
    and never reads or writes out of bounds."""
    check(aob2, "aob2", 3)
    check(code2, "code2", 3)
    same_device(aob2, code2)
    if aob2.shape != code2.shape:
        raise ValueError(f"aob2 {tuple(aob2.shape)} and code2 {tuple(code2.shape)} differ")
    if aob2.device.type == "cpu":
        return fold_records_plain(aob2, code2)
    B, Mg, S = aob2.shape
    if B > 65535 or Mg >= 2**31 or S >= 2**31:
        raise ValueError(f"fold_records shape {tuple(aob2.shape)} out of range")
    rec = torch.empty(B, FOLD_CAPW, Mg, dtype=torch.int32, device=aob2.device)
    k = torch.empty(B, Mg, dtype=torch.int32, device=aob2.device)
    launch(
        "fold_records", "nt_fold_records", ptr(aob2), ptr(code2), ptr(rec), ptr(k),
        ctypes.c_int(B), ctypes.c_int(Mg), ctypes.c_int(S),
        device=aob2.device,
    )
    return rec, k


# ---------------------------------------------------------------------------
# value join (replaces pallas_ops.value_join_pallas)
# ---------------------------------------------------------------------------


def value_join_plain(bins, val_tbl):
    """bins (K, B, M) int32 canonical-index bins; val_tbl (B, 858) int32 ->
    (K, B, M) int32 values.  A bin >= 858 is a hole and maps to 0; a
    negative bin reads entry 0, as the gather of JAX's `_sym_join` does."""
    K, B, M = bins.shape
    live = bins < NSYM
    idx = bins.clamp(0, NSYM - 1).to(torch.int64)
    tbl = val_tbl[None].expand(K, B, NSYM)
    return torch.where(live, tbl.gather(2, idx), 0)


def value_join(bins, val_tbl):
    """Per-image table lookup of K slot arrays in one launch:
    (K, B, M) bins, (B, 858) table -> (K, B, M) values."""
    check(bins, "bins", 3)
    check(val_tbl, "val_tbl", 2)
    same_device(bins, val_tbl)
    K, B, M = bins.shape
    if val_tbl.shape != (B, NSYM):
        raise ValueError(f"val_tbl must be ({B}, {NSYM})")
    if bins.device.type == "cpu":
        return value_join_plain(bins, val_tbl)
    if K * B > 65535:
        raise ValueError("value_join takes at most 65535 slot arrays")
    out = torch.empty_like(bins)
    launch(
        "value_join", "nt_value_join", ptr(bins), ptr(val_tbl), ptr(out), ctypes.c_int(K),
        ctypes.c_int(B), ctypes.c_longlong(M), device=bins.device,
    )
    return out


# ---------------------------------------------------------------------------
# Huffman tables (replaces huffman_dev.py build_tables_device, a jitted jnp
# program; the plain version is huffman_dev.build_tables_device_plain)
# ---------------------------------------------------------------------------


def huffman_tables(counts: torch.Tensor):
    """(B, 858) int32 or int64 histograms -> (lengths (B, 858) int32, codes
    (B, 858) int32 bit patterns of the uint32 codes, overflow (B,) bool), in
    one launch that reads nothing back to the host.  Equal to
    `huffman_dev.build_tables_device_plain` for non-negative counts whose
    stream totals stay below 2**52."""
    check_per_symbol(counts, "counts", "huffman_tables")
    if counts.device.type == "cpu":
        from nicetpu_torch.kernels.huffman_dev import build_tables_device_plain

        return build_tables_device_plain(counts)
    B = counts.shape[0]
    counts = counts.contiguous()
    lengths = torch.empty(B, NSYM, dtype=torch.int32, device=counts.device)
    codes = torch.empty_like(lengths)
    stream_ovf = torch.empty(B, C.NUM_STREAMS, dtype=torch.bool, device=counts.device)
    launch(
        "huffman_tables", "nt_huffman_tables", ptr(counts),
        ctypes.c_int(int(counts.dtype == torch.int64)), ptr(lengths), ptr(codes), ptr(stream_ovf),
        ctypes.c_int(B), device=counts.device,
    )
    return lengths, codes, stream_ovf.any(dim=1)


# ---------------------------------------------------------------------------
# tokenizer (replaces encode2.py _tokenize_core, jnp inside the jitted
# tokenize_compact and encode_fused; the plain version and the dispatching
# wrapper are tokenize.tokenize_bins_plain and tokenize.tokenize_bins)
# ---------------------------------------------------------------------------

TOKENIZE_SPAN = 1024  # pixels a block of the kernel takes, as kSpan in csrc/tokenize_kernels.cu


def _tokenize_geometry(x_ext: torch.Tensor, halo: int) -> tuple[int, int, int, int]:
    """(B, n_ext, n_local, spans) of a checked CUDA x_ext; raises on what the
    kernels do not take."""
    if x_ext.device.type != "cuda":
        raise ValueError(f"the tokenizer kernel takes a CUDA tensor, got {x_ext.device}")
    B, n_ext, _ = x_ext.shape
    n_local = n_ext - halo
    spans = -(-n_local // TOKENIZE_SPAN)
    if B > 65535 or B * spans >= 2**31:
        raise ValueError(f"the tokenizer takes at most 65535 images and 2**31 spans, got {B} x {spans}")
    return B, n_ext, n_local, spans


def first_change(x_ext: torch.Tensor, *, halo: int, g0: int, n_total: int) -> torch.Tensor:
    """One launch of the kernel's `first_change_kernel` on a checked (B, halo
    + n_local, 3) uint8 CUDA tensor: (B,) int32, each image's first changed
    global position among its local pixels, else n_total.  Not counted: it
    belongs to the sharded path's `tokenize`."""
    B, n_ext, n_local, _ = _tokenize_geometry(x_ext, halo)
    first = torch.empty(B, dtype=torch.int32, device=x_ext.device)
    launch(
        None, "nt_first_change", ptr(x_ext), ptr(first), ctypes.c_int(B), ctypes.c_longlong(n_ext),
        ctypes.c_longlong(halo), ctypes.c_longlong(n_local), ctypes.c_longlong(g0),
        ctypes.c_longlong(n_total), device=x_ext.device,
    )
    return first


def tokenize(x_ext, tail, *, width: int, halo: int, g0: int, n_total: int, ndigits_cap: int,
             invalid_bin: int, geo=None):
    """The kernel (one counted launch after one memset) on checked CUDA
    inputs, tail None or a 1-D int32 tensor.  Returns (bins (B, n_local * (5
    + ndigits_cap)) int32, overflow (B,) bool).  The overflow flags are the
    first B bytes of the call's scratch, which the kernel's memset zeroes
    and which also holds the ticket and one word a span.  geo: None, or a
    batch's (B, geometry.COLS) int32 table, whose widths and pixel counts
    replace width and n_total image by image (each image's bins past its
    pixels are holes)."""
    B, n_ext, n_local, spans = _tokenize_geometry(x_ext, halo)
    S = 5 + ndigits_cap
    bins = torch.empty(B, n_local * S, dtype=torch.int32, device=x_ext.device)
    ticket_at = -(-B // 8) * 8
    scratch = torch.empty(ticket_at + 4 * (1 + B * spans), dtype=torch.uint8, device=x_ext.device)
    n_tail = 0 if tail is None else tail.numel()
    launch(
        "tokenize", "nt_tokenize_bins", ptr(x_ext), ctypes.c_void_p(tail.data_ptr() if n_tail else None),
        ctypes.c_int(n_tail), ptr(bins), ptr(scratch), ctypes.c_longlong(scratch.numel()),
        ctypes.c_longlong(ticket_at), ctypes.c_int(B), ctypes.c_longlong(n_ext), ctypes.c_longlong(halo),
        ctypes.c_longlong(n_local), ctypes.c_longlong(g0), ctypes.c_longlong(n_total), ctypes.c_int(width),
        ctypes.c_int(ndigits_cap), ctypes.c_int(invalid_bin), _geo_ptr(geo), device=x_ext.device,
    )
    return bins, scratch[:B].view(torch.bool)


def _geo_ptr(geo) -> ctypes.c_void_p:
    """A geometry table's device pointer for the kernels, null for none."""
    return ptr(geo) if geo is not None else ctypes.c_void_p(0)


# ---------------------------------------------------------------------------
# decode tables (replace decode3.py prepare_tables_v3_jnp and
# derive_walk_tables, jnp inside the jitted round trip and decode core; the
# plain versions are decode3.prepare_tables_v3_plain and
# decode3.derive_walk_tables_plain)
# ---------------------------------------------------------------------------

TABLE_LENGTHS = 32  # code lengths 0..31 a stream in af/present/ib/aff/dD/inc


@functools.lru_cache(maxsize=None)
def _table_layout(B: int, walk: bool) -> tuple:
    """Where `decode_tables`' outputs lie in its one buffer, in the kernel's
    order (nt_decode_tables): ((shape, strides, int32 offset) of af,
    present, ib, pfx16, sym_tbl, stream_max[, aff, dD, inc]), tables_ok's
    byte offset, and the buffer's bytes (whole int32 words)."""
    row = (B, C.NUM_STREAMS, TABLE_LENGTHS)
    shapes = [row] * 3 + [(B, 1, 16), (B, NSYM), (B, C.NUM_STREAMS)] + [row] * (3 * walk)
    tables, at = [], 0
    for shape in shapes:
        strides = tuple(math.prod(shape[k + 1 :]) for k in range(len(shape)))
        tables.append((shape, strides, at))
        at += math.prod(shape)
    return tuple(tables), 4 * at, 4 * (at + -(-B // 4))


def _carve_tables(buf: torch.Tensor, B: int, walk: bool) -> tuple:
    """The tables of `decode_tables` as contiguous views of its one bool
    buffer, in the wrapper's order: tables_ok (the buffer's bytes at its
    offset) seventh.  One `as_strided` a table: the cheapest view to make."""
    layout, ok_at, _ = _table_layout(B, walk)
    words = buf.view(torch.int32)
    tables = [words.as_strided(shape, strides, at) for shape, strides, at in layout]
    tables.insert(6, buf[ok_at : ok_at + B])
    return tuple(tables)


def decode_tables(lens: torch.Tensor, *, walk: bool = False):
    """(B, 858) int32 or int64 code lengths -> (af, present, ib (B, 10, 32),
    pfx16 (B, 1, 16), sym_tbl (B, 858), stream_max (B, 10), all int32, and
    tables_ok (B,) bool), and where walk is true also the walk's (aff, dD,
    inc), each (B, 10, 32) int32: ten tables in one launch that reads
    nothing back to the host.  The outputs are contiguous views of one
    allocation.  Equal to `decode3.prepare_tables_v3_plain` (and
    `decode3.derive_walk_tables_plain` of its first three) for any
    lengths."""
    check_per_symbol(lens, "lens", "decode_tables")
    if lens.device.type == "cpu":
        from nicetpu_torch.kernels.decode3 import derive_walk_tables_plain, prepare_tables_v3_plain

        tables = prepare_tables_v3_plain(lens)
        return tables + derive_walk_tables_plain(*tables[:3]) if walk else tables
    B = lens.shape[0]
    lens = lens.contiguous()
    buf = torch.empty(_table_layout(B, walk)[2], dtype=torch.bool, device=lens.device)
    launch(
        "decode_tables", "nt_decode_tables", ptr(lens), ctypes.c_int(int(lens.dtype == torch.int64)), ptr(buf),
        ctypes.c_int(int(walk)), ctypes.c_int(B), device=lens.device,
    )
    return _carve_tables(buf, B, walk)


def walk_tables(af: torch.Tensor, present: torch.Tensor, ib: torch.Tensor):
    """(B, 10, 32) int32 af, present (nonzero: present) and ib, any values
    -> the walk's (aff, dD, inc), each (B, 10, 32) int32, in one launch.
    Equal to `decode3.derive_walk_tables_plain`."""
    for t, name in ((af, "af"), (present, "present"), (ib, "ib")):
        check(t, name, 3)
        if tuple(t.shape[1:]) != (C.NUM_STREAMS, TABLE_LENGTHS):
            raise ValueError(f"{name} must be (B, {C.NUM_STREAMS}, {TABLE_LENGTHS}), got {tuple(t.shape)}")
    same_device(af, present, ib)
    if not af.shape == present.shape == ib.shape:
        raise ValueError(f"af, present, ib shapes differ: {tuple(af.shape)}, {tuple(present.shape)}, "
                         f"{tuple(ib.shape)}")
    if af.device.type == "cpu":
        from nicetpu_torch.kernels.decode3 import derive_walk_tables_plain

        return derive_walk_tables_plain(af, present, ib)
    B = af.shape[0]
    if B > 65535:
        raise ValueError("walk_tables takes at most 65535 images")
    aff = torch.empty_like(af)
    dD = torch.empty_like(af)
    inc = torch.empty_like(af)
    launch(
        "walk_tables", "nt_walk_tables", ptr(af), ptr(present), ptr(ib), ptr(aff), ptr(dD), ptr(inc),
        ctypes.c_int(B), device=af.device,
    )
    return aff, dD, inc


# ---------------------------------------------------------------------------
# slot assembly (replaces decode3.py _slot_starts and _compact, torch scans
# standing for JAX's in-layout _cumsum_walk and _cummax_walk; the plain
# version is decode3.slot_assemble_plain)
# ---------------------------------------------------------------------------

SLOT_SUMMARY_INTS = 16  # a chunk's summary in the kernels' scratch, as kSumInts
SLOT_CARRY_INTS = 4  # a chunk's carry, as kCarryInts


def slot_assemble(pos, sym, i12, i34, wbits, *, n_pixels: int | None = None,
                  geom: geometry.Geometry | None = None):
    """The decode core's slot assembly: the walk's final-round records (B,
    nch, steps) int32 and wbits (B,) int32 -> (sym, i12, i34 (B, K) int32,
    start (B, K) int64, live (B, K) bool, ok_cov (B,) bool): each image's
    real slots (prefixes whose pixel start is below n_pixels) in order, K
    the largest count of any image (at least 1), a hole's symbol, 0, 0 and
    n_pixels past each count; ok_cov: the coverage reaches n_pixels.  One
    of n_pixels (every image's) and geom (the batch's `geometry.Geometry`:
    each image's own pixel count, read from its table).  Equal to
    `decode3.slot_assemble_plain` for any records.

    On a card (`csrc/slot_assemble_kernels.cu`): one call launches the
    chunk summaries and the per-image scan, counted once in
    `LAUNCHES["slot_assemble"]`; one read of the (B,) real counts sizes K
    (the call's only host sync); a second call compacts.  Scratch is 80
    bytes a chunk, nothing a slot.  A view that is not contiguous is copied
    first."""
    ts = {"pos": pos, "sym": sym, "i12": i12, "i34": i34}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be an int32 torch.Tensor")
        if t.dim() != 3 or t.numel() == 0 or t.shape != pos.shape:
            raise ValueError(f"{name} must be non-empty (B, nch, steps) like pos, got {tuple(t.shape)}")
    B, nch, steps = pos.shape
    if not isinstance(wbits, torch.Tensor) or wbits.dtype != torch.int32 or tuple(wbits.shape) != (B,):
        raise ValueError(f"wbits must be a ({B},) int32 tensor")
    same_device(pos, sym, i12, i34, wbits)
    if (n_pixels is None) == (geom is None):
        raise ValueError("slot_assemble takes one of n_pixels and geom")
    if geom is not None:
        if geom.batch != B:
            raise ValueError(f"a geometry of {geom.batch} images for {B} images of records")
        n_pixels = geom.n_max
    if pos.device.type == "cpu":
        from nicetpu_torch.kernels.decode3 import slot_assemble_plain

        return slot_assemble_plain(pos, sym, i12, i34, wbits,
                                   n_pixels if geom is None else geom.column(geometry.N).to(torch.int64))
    if pos.device.type != "cuda":
        raise ValueError(f"pos is on unsupported device {pos.device}")
    if B > 65535 or steps >= 2**23 or nch * steps >= 2**31 or n_pixels < 1:
        raise ValueError(f"slot_assemble of {B} x {nch} x {steps} slots over {n_pixels} pixels is out of range")
    pos, sym, i12, i34, wbits = (t.contiguous() for t in (pos, sym, i12, i34, wbits))
    vec = int(steps % 4 == 0 and pos.data_ptr() % 16 == 0 and sym.data_ptr() % 16 == 0)
    dev = pos.device
    at = B * nch * (SLOT_SUMMARY_INTS + SLOT_CARRY_INTS)
    scratch = torch.empty(at + B + -(-B // 4), dtype=torch.int32, device=dev)
    N = ctypes.c_longlong(n_pixels)
    table = _geo_ptr(geom.table if geom is not None else None)
    launch("slot_assemble", "nt_slot_scan", ptr(pos), ptr(sym), ptr(wbits), ptr(scratch), ctypes.c_int(B),
           ctypes.c_int(nch), ctypes.c_int(steps), N, table, ctypes.c_int(vec), device=dev)
    K = max(1, max(scratch[at : at + B].tolist()))
    out = [torch.empty(B, K, dtype=torch.int32, device=dev) for _ in range(3)]
    start = torch.empty(B, K, dtype=torch.int64, device=dev)
    live = torch.empty(B, K, dtype=torch.bool, device=dev)
    launch(None, "nt_slot_compact", ptr(pos), ptr(sym), ptr(i12), ptr(i34), ptr(wbits), ptr(scratch),
           *(ptr(t) for t in out), ptr(start), ptr(live), ctypes.c_int(B), ctypes.c_int(nch), ctypes.c_int(steps),
           N, ctypes.c_longlong(K), table, ctypes.c_int(vec), device=dev)
    return (*out, start, live, scratch[at + B :].view(torch.bool)[:B])


# ---------------------------------------------------------------------------
# stitch (replaces no kernel: JAX's dist/sharded.py stitch_payload is host
# numpy; the plain version is dist.sharded.stitch_file_plain)
# ---------------------------------------------------------------------------

STITCH_MAX_SHARDS = 128  # shards a launch takes, as kMaxShards in csrc/stitch_kernels.cu
STITCH_MAX_HEADER = 1024  # header bytes a launch takes, as kMaxHeader


def stitch_file(words: torch.Tensor, bits, header: bytes) -> torch.Tensor:
    """The `.nice` file of a sharded encode: words (n, k) int32, row d the
    bit patterns of shard d's payload words; bits (n,) the shards' bit
    totals (host integers); header the file's header bytes.  Returns one
    uint8 tensor on the words' device: the header, the shards' bit strings
    in order (shard d from the sum of the totals before it) cut after the
    last whole byte, and the trailer [B, B, 0, 0, 0], B the partial last
    byte or 0.  Equal to `sharded._file_bytes(header, *stitch_payload(...))`
    where each shard's bits past its total are zero, as the encoder leaves
    them (the kernel never reads them).

    On a card, one counted launch that allocates nothing; the output is the
    call's one allocation.  Raises ValueError, before any launch, where a
    shard's total passes its 32 * k bits."""
    check(words, "words", 2)
    n, k = words.shape
    bits = np.asarray(bits, dtype=np.int64)
    if bits.shape != (n,) or (bits < 0).any():
        raise ValueError(f"bits must be ({n},) non-negative totals, got {bits!r}")
    if int(bits.max()) > 32 * k:
        raise ValueError("shard payload exceeded its word capacity; re-run with a larger "
                         "w_cap (pathological bits/pixel)")
    if words.device.type == "cpu":
        from nicetpu_torch.dist.sharded import stitch_file_plain

        return stitch_file_plain(words, bits, header)
    if n > STITCH_MAX_SHARDS or len(header) > STITCH_MAX_HEADER:
        raise ValueError(f"stitch_file takes at most {STITCH_MAX_SHARDS} shards and {STITCH_MAX_HEADER} "
                         f"header bytes, got {n} and {len(header)}")
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(bits, out=off[1:])
    out = torch.empty(len(header) + int(off[-1]) // 8 + 5, dtype=torch.uint8, device=words.device)
    launch(
        "stitch", "nt_stitch_file", ptr(words), ctypes.c_longlong(k), off.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(n), ctypes.c_char_p(header), ctypes.c_int(len(header)), ptr(out),
        ctypes.c_longlong(out.numel()), device=words.device,
    )
    return out
