"""The `.nice` device decode (v3) in PyTorch: speculative chunk walk, value
join, slot assembly, placement and row reconstruction, plus the fused round
trip and decode from bytes.

Counterpart of `nicetpu/kernels/decode3.py`, with the same results for the
same `WalkCfg`:

1. **Chunk walk** (`walk`, CUDA kernel `nt_walk`): the payload is cut into
   `chunk_bits`-bit chunks, one thread each, and every chunk is walked one
   pixel group per step (prefix -> payload codes, ref code.rs:576-651) by
   canonical threshold decode over the `derive_walk_tables` layout.  Entries
   are speculative (self-synchronizing Huffman): round 1 walks from the
   chunk starts, each later round from the previous round's exits anchored
   at bit 0; if the final exits reproduce their entries, induction from the
   anchor proves every entry true.  Any miss clears `ok` and the caller
   retries on the next ladder rung or decodes on the host.
2. **Assembly** (torch ops): the walk writes its records in serial order,
   (B, chunks, steps), so run values and pixel starts come from plain
   `torch.cumsum` / `torch.cummax` along one axis.  The TPU's (R, 128)
   record tiling, `make_word_blocks` and the in-layout scans are not ported.
   The decode core frees each slot temporary once it is used, sums in
   place and keeps only each image's real pixels' slots after the coverage
   sums (`_slot_starts`, `_compact`), so that one card decodes every stream
   it accepts; `decode_batch_v3` sizes its device batches from that
   reckoning (`decode_bytes`) against the card's free memory.
3. **Value join** (`cuda_ops.value_join`): canonical index -> symbol.
4. **Placement** (one scatter of packed records) and the **row
   reconstruction** (`recon.reconstruct_rows`).

uint32 words travel as int32 bit patterns (see `convert`).  Tables keep the
JAX layouts: af/present/ib/aff/dD/inc (B, 10, 32) int32, pfx16 (B, 1, 16),
sym_tbl (B, 858).  Every decode path builds all ten tables, the walk's
with the rest, on the device in one launch a batch
(`prepare_tables_v3(..., walk=True)` -> `cuda_ops.decode_tables`), as JAX
builds them inside its jitted programs, and hands the walk's to every rung
(`_decode_core_v3(..., walk_tables=)`).  `derive_walk_tables` ->
`cuda_ops.walk_tables` derives the walk's tables from any af/present/ib in
a launch of its own.  The plain versions are `prepare_tables_v3_plain` and
`derive_walk_tables_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nicetpu_torch.convert import MASK32, from_int32_bits, to_int32_bits
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.format.huffman import validate_flat_lengths
from nicetpu_torch.kernels import cuda_ops, recon
from nicetpu_torch.kernels.decode_dev import F_ADD1, F_CONST, F_HALF, SLOT_STREAM, _const_offsets, _sel
from nicetpu_torch.kernels.encode2 import encode_fused_core
from nicetpu_torch.utils.profiling import span

# ---------------------------------------------------------------------------
# Walk geometry
# ---------------------------------------------------------------------------


class WalkCfg(NamedTuple):
    """One walk configuration (a retry-ladder rung).

    chunk_bits: payload bits per speculative chunk (the self-sync margin).
    rows: the JAX kernel's sublane rows per block; kept so that tests build
      the same rungs, and unused on the card.
    steps_div: step budget divisor (budget = chunk_bits / steps_div, rounded
      up to a multiple of SBLK); a chunk whose groups average fewer bits
      exhausts it and fails the crossing gate.
    rounds: speculative walk rounds.
    """

    chunk_bits: int
    rows: int
    steps_div: int
    rounds: int


# Retry ladder: the fast rung first, then the robust one (big self-sync
# margin, deep step budget); images still failing go to the host.
LADDER = (WalkCfg(2048, 32, 8, 2), WalkCfg(4096, 8, 3, 3))
SBLK = 32  # step budgets round up to a multiple of this, as in the JAX walk

# Payloads of this many bits or more are decoded on the host
# (`decode_batch_v3`) and never verified on the device (`roundtrip_verify_fused`).
# The walk keeps bit positions in int32, and the bound of a payload's last
# chunk, one chunk past its end, must stay below 2**31: the margin of 2**16
# covers chunks up to 2**15 bits.  The sharded decode keeps its positions
# relative to each shard instead (`dist/sharded_decode.py`).
MAX_DEVICE_BITS = 2**31 - 2**16

_MSB = -0x80000000  # int32 sign bit
_I32_MAX = 0x7FFFFFFF
_PAD_BIN = 1023  # a hole in the payload bins (>= 858)


def _wrows(chunk_bits: int) -> int:
    """Zero words kept past the last chunk's words (the walk's lookahead)."""
    return chunk_bits // 32 + 8


def _steps(chunk_bits: int, steps_div: int) -> int:
    return -(-(chunk_bits // steps_div) // SBLK) * SBLK


def _deep_cap(s: int) -> int:
    """Deepest possible code length for stream s (Huffman depth <= n-1;
    the encoder's clamp bounds everything at MAX_CODE_LEN)."""
    return min(C.MAX_CODE_LEN, C.ALPHABET_SIZES[s] - 1)


# ---------------------------------------------------------------------------
# Decode tables on the device
# ---------------------------------------------------------------------------


def prepare_tables_v3(lens_b: torch.Tensor, *, walk: bool = False):
    """(B, 858) int32 or int64 code lengths -> the decode tables, built on
    their device: (af (B, 10, 32) int32 bit patterns of the left-aligned
    first codes (0xFFFFFFFF where a length is absent), present, ib,
    pfx16 (B, 1, 16), sym_tbl (B, 858), stream_max (B, 10), tables_ok (B,)),
    and where walk is true also `derive_walk_tables` of the first three
    (aff, dD, inc), ten tables in all.

    Port of `prepare_tables_v3_jnp`.  tables_ok is `validate_flat_lengths`
    on the device: lengths in 1..=31 and a Kraft sum of exactly 2**32 per
    stream, summed in int64 (the JAX int32 sum also accepts multiples of
    2**32).  On a CUDA tensor one launch of the decode_tables kernel
    (`cuda_ops.decode_tables`, `csrc/decode_tables_kernels.cu`) with nothing
    read back, as JAX builds them inside its jitted round trip; on a CPU
    tensor the plain versions, `prepare_tables_v3_plain` and
    `derive_walk_tables_plain`."""
    return cuda_ops.decode_tables(lens_b, walk=walk)


def prepare_tables_v3_plain(lens_b: torch.Tensor):
    """The plain version of `prepare_tables_v3`, in torch operations: per
    stream a clamp, an argsort by (length, symbol) and the first codes from
    an int64 cumsum."""
    lens_all = lens_b.to(torch.int64)
    B, dev = lens_all.shape[0], lens_all.device
    i32 = dict(dtype=torch.int32, device=dev)
    af = torch.full((B, C.NUM_STREAMS, 32), -1, **i32)
    present = torch.zeros((B, C.NUM_STREAMS, 32), **i32)
    ib = torch.zeros((B, C.NUM_STREAMS, 32), **i32)
    sym_tbl = torch.zeros((B, C.TOTAL_SYMBOLS), **i32)
    pfx16 = torch.zeros((B, 1, 16), **i32)
    stream_max = torch.zeros((B, C.NUM_STREAMS), **i32)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    lvals = torch.arange(32, device=dev)
    for s in range(C.NUM_STREAMS):
        base, size = C.STREAM_BASE[s], C.ALPHABET_SIZES[s]
        lens = lens_all[:, base : base + size]
        lens_c = lens.clamp(1, C.MAX_CODE_LEN)
        ok &= ((lens >= 1) & (lens <= C.MAX_CODE_LEN)).all(dim=1)
        stream_max[:, s] = lens_c.max(dim=1).values.to(torch.int32)
        # canonical order: (length asc, symbol asc); the keys are unique
        order = torch.argsort(lens_c * 1024 + torch.arange(size, device=dev), dim=1)
        sorted_lens = lens_c.gather(1, order)
        sym_tbl[:, base : base + size] = order.to(torch.int32)
        if s == C.SC_PREFIXES:
            pfx16[:, 0, :size] = order.to(torch.int32)
        # left-aligned first codes: A_i = sum_{j<i} 2^(32 - l_j)
        contrib = torch.ones_like(sorted_lens) << (32 - sorted_lens)
        incl = torch.cumsum(contrib, dim=1)
        A = incl - contrib
        ok &= incl[:, -1] == 1 << 32
        cnt_lt = (sorted_lens[:, None, :] < lvals[None, :, None]).sum(dim=2)  # (B, 32)
        cnt_le = (sorted_lens[:, None, :] <= lvals[None, :, None]).sum(dim=2)
        pres = cnt_le > cnt_lt
        A_first = A.gather(1, cnt_lt.clamp(max=size - 1))
        present[:, s] = pres.to(torch.int32)
        ib[:, s] = torch.where(pres, cnt_lt, 0).to(torch.int32)
        af[:, s] = torch.where(pres, to_int32_bits(A_first & MASK32), -1)
    return af, present, ib, pfx16, sym_tbl, stream_max, ok


def derive_walk_tables(af, present, ib):
    """(B, 10, 32) int32 af/present/ib -> the walk's threshold tables (aff,
    dD, inc), each (B, 10, 32) int32 (see `derive_walk_tables_plain`).  On
    CUDA tensors one launch of the walk_tables kernel
    (`cuda_ops.walk_tables`); on CPU tensors the plain version."""
    return cuda_ops.walk_tables(af, present, ib)


def derive_walk_tables_plain(af, present, ib):
    """(B, 10, 32) af/present/ib -> the walk's threshold tables (aff, dD,
    inc), each (B, 10, 32) int32 (see the JAX `derive_walk_tables`):

      aff[l] = biased af of the first present length >= l (INT32_MAX if none)
      hit_l  = (win ^ MSB) >= aff[l]   <=>   l <= L  (monotone in l)
      L      = sum_l hit_l * inc[l]
      idx    = sum_l hit_l * dD[l] + (win >>> (32 - L))

    dD telescopes ib[l'] - (af[l'] >>> (32 - l')) over the last present
    l' <= l, in wrapping int32 arithmetic; inc[l] = 1 up to the longest
    present length."""
    pres = present != 0
    aff = torch.where(pres, af ^ _MSB, _I32_MAX)
    aff = torch.flip(torch.cummin(torch.flip(aff, (-1,)), dim=-1).values, (-1,))
    l_idx = torch.arange(32, device=af.device)
    fc = from_int32_bits(af) >> ((32 - l_idx) & 31)
    D_at = torch.where(pres, ib.to(torch.int64) - fc, 0)
    last = torch.cummax(torch.where(pres, l_idx, -1), dim=-1).values
    D_ff = torch.where(last >= 0, D_at.gather(-1, last.clamp(min=0)), 0)
    dD = D_ff - F.pad(D_ff[..., :-1], (1, 0))
    inc = l_idx <= last[..., -1:].clamp(min=0)
    return aff.to(torch.int32), to_int32_bits(dD & MASK32), inc.to(torch.int32)


WALK_TILE = 8  # the kernel stores records this many steps at a time (kTile)


# ---------------------------------------------------------------------------
# The walk (replaces decode3.walk_pallas)
# ---------------------------------------------------------------------------


def _stream_tables(aff, dD, inc) -> dict:
    """Per stream s: its (aff, inc, dD) thresholds over lengths
    1.._deep_cap(s), as (B, 1, cap) int64 columns."""
    tabs = {}
    for s in range(C.NUM_STREAMS):
        cut = slice(1, _deep_cap(s) + 1)
        tabs[s] = tuple(t[:, None, s, cut].to(torch.int64) for t in (aff, inc, dD))
    return tabs


def _canon_decode(win, tabs, s: int):
    """(L, idx) of the canonical codeword at each window for stream s.

    win: int64 uint32 windows; idx carries the int32 value of JAX's
    wrapping sums.  The monotone threshold count runs over every length up
    to `_deep_cap(s)`: the JAX walk's `maxl`/GATING skips only lengths whose
    thresholds cannot be met, so the sums are the same."""
    t_aff, t_inc, t_dD = tabs[s]
    hit = (win - 2**31)[..., None] >= t_aff  # (win ^ MSB) as int32
    L = (hit * t_inc).sum(dim=-1)
    idx = ((hit * t_dD).sum(dim=-1) + (win >> (32 - L.clamp(min=1)))) & MASK32
    return L, torch.where(idx >= 2**31, idx - 2**32, idx)


def _decode_group(p, win_at, tabs, pfx64):
    """One pixel-group decode at bit positions p (ref code.rs:576-651):
    the prefix symbol, then the payload codes of its mode's slot streams.
    Returns (sym, [idx1..idx4], q_next); a slot the mode does not use has
    index 0 and adds no bits."""
    L0, idx0 = _canon_decode(win_at(p), tabs, C.SC_PREFIXES)
    is_sym = (idx0 >= 0) & (idx0 < C.ALPHABET_SIZES[C.SC_PREFIXES])
    sym = torch.where(is_sym, pfx64.gather(1, idx0.clamp(0, 15)), 0)
    q = p + L0
    idxs = []
    for k in range(C.MODE_PAYLOAD_SLOTS):
        win = win_at(q)
        modes = [m for m in range(5) if SLOT_STREAM[m][k] >= 0]
        dec = {s: _canon_decode(win, tabs, s) for s in {SLOT_STREAM[m][k] for m in modes}}
        Lk = torch.zeros_like(q)
        ik = torch.zeros_like(q)
        for m in modes:
            Ls, Is = dec[SLOT_STREAM[m][k]]
            Lk = torch.where(sym == m, Ls, Lk)
            ik = torch.where(sym == m, Is, ik)
        idxs.append(ik)
        q = q + Lk
    return sym, idxs, q


def walk_plain(words, entries, aff, dD, inc, pfx, wbits, *, chunk_bits: int, steps: int,
               records: bool = True):
    """`walk_ref` batched in torch: the plain version of the walk kernel.

    words (B, Wn) int32 bit patterns; entries (B, nch) int32 bit positions
    in the words; aff/dD/inc (B, 10, 32); pfx (B, 1, 16); wbits (B,).
    Returns (pos, sym, i12, i34), each (B, nch, steps) int32 in serial order
    (pos = -1 where a chunk is frozen), and exits (B, nch); the four record
    arrays are None when records is False.  Chunk c ends at bit (c + 1) *
    chunk_bits.  Windows past the last word read the last word, as in
    `walk_ref`; a window before bit 0 (a shard's entry from the previous
    shard's chunk that failed to cross, which the gates reject; see
    `dist/sharded_decode.py`) reads the first word."""
    B, Wn = words.shape
    nch = entries.shape[1]
    dev = words.device
    wu = from_int32_bits(words)
    bound = ((torch.arange(nch, device=dev) + 1) * chunk_bits)[None, :]
    wb = wbits.to(torch.int64)[:, None]
    pfx64 = pfx.reshape(B, 16).to(torch.int64)
    tabs = _stream_tables(aff, dD, inc)

    def win_at(q):
        w = q >> 5
        sh = q & 31
        w0 = wu.gather(1, w.clamp(0, Wn - 1))
        w1 = wu.gather(1, (w + 1).clamp(0, Wn - 1))
        lo = torch.where(sh == 0, 0, w1 >> (32 - sh))
        return ((w0 << sh) & MASK32) | lo

    p = entries.to(torch.int64)
    recs = None
    if records:
        recs = [torch.zeros(B, nch, steps, dtype=torch.int32, device=dev) for _ in range(4)]
        recs[0].fill_(-1)
    for t in range(steps):
        alive = (p < bound) & (p < wb)
        if not bool(alive.any()):
            break  # every chunk is frozen: the rest are dead records
        sym, idxs, q = _decode_group(p, win_at, tabs, pfx64)
        if records:
            i12 = (idxs[0] & MASK32) | ((idxs[1] << 16) & MASK32)  # int32 idx0 | idx1 << 16
            i34 = (idxs[2] & MASK32) | ((idxs[3] << 16) & MASK32)
            for rec, v, dead in zip(recs, (p, sym, i12, i34), (-1, 0, 0, 0)):
                rec[:, :, t] = torch.where(alive, to_int32_bits(v & MASK32), dead)
        p = torch.where(alive, torch.maximum(p + 1, q), p)
    exits = p.to(torch.int32)
    if not records:
        return None, None, None, None, exits
    return (*recs, exits)


def walk(words, entries, aff, dD, inc, pfx, wbits, *, chunk_bits: int, steps: int,
         records: bool = True):
    """The speculative chunk walk (see `walk_plain` for shapes and results):
    launches `nt_walk` for CUDA tensors, runs `walk_plain` for CPU ones.
    records=False skips the record stores (the non-final rounds need only
    the exits) and returns None for the four record arrays.  Positions are
    int32: the callers keep them below 2**31 (`MAX_DEVICE_BITS`, and the
    shard-relative positions of the sharded decode)."""
    for t, name, nd in ((words, "words", 2), (entries, "entries", 2), (aff, "aff", 3),
                        (dD, "dD", 3), (inc, "inc", 3), (pfx, "pfx", 3), (wbits, "wbits", 1)):
        cuda_ops.check(t, name, nd)
    cuda_ops.same_device(words, entries, aff, dD, inc, pfx, wbits)
    B, Wn = words.shape
    nch = entries.shape[1]
    if entries.shape[0] != B or wbits.shape != (B,) or pfx.shape != (B, 1, 16):
        raise ValueError("entries, wbits and pfx must share the batch of words")
    if any(t.shape != (B, C.NUM_STREAMS, 32) for t in (aff, dD, inc)):
        raise ValueError(f"walk tables must be ({B}, {C.NUM_STREAMS}, 32)")
    if chunk_bits % 32 or chunk_bits <= 0 or steps % WALK_TILE or steps <= 0:
        raise ValueError(f"bad walk geometry chunk_bits={chunk_bits} steps={steps} (steps must "
                         f"be a positive multiple of {WALK_TILE})")
    if words.device.type == "cpu":
        return walk_plain(words, entries, aff, dD, inc, pfx, wbits, chunk_bits=chunk_bits,
                          steps=steps, records=records)
    if B > 65535 or (nch + 1) * chunk_bits >= 2**31:
        raise ValueError(f"walk of {B} x {nch} chunks of {chunk_bits} bits is out of range")
    exits = torch.empty(B, nch, dtype=torch.int32, device=words.device)
    recs = [None] * 4
    if records:
        recs = [torch.empty(B, nch, steps, dtype=torch.int32, device=words.device) for _ in range(4)]
    rp = [cuda_ops.ptr(r) if r is not None else ctypes.c_void_p(0) for r in recs]
    cuda_ops.launch(
        "walk", "nt_walk", cuda_ops.ptr(words), ctypes.c_int(Wn), cuda_ops.ptr(entries),
        cuda_ops.ptr(aff), cuda_ops.ptr(dD), cuda_ops.ptr(inc), cuda_ops.ptr(pfx),
        cuda_ops.ptr(wbits), *rp, cuda_ops.ptr(exits), ctypes.c_int(B), ctypes.c_int(nch),
        ctypes.c_int(chunk_bits), ctypes.c_int(steps), device=words.device,
    )
    return (*recs, exits)


# ---------------------------------------------------------------------------
# Assembly: walk records -> packed placement records (element-wise + scans)
# ---------------------------------------------------------------------------

REC_DEFAULT = F_ADD1  # form=ADD1, ref 0, deltas 0: the run-covered transfer
RECORD_BLOCK = 1 << 23  # slots a pass of slot_records takes (bounds its temporaries)


def _payload_bins(sym, i12, i34):
    """Walk records -> (4, ...) slot-wise flat canonical bins (holes 1023)."""
    idx = (i12 & 0xFFFF, i12 >> 16, i34 & 0xFFFF, i34 >> 16)
    bins = torch.full((C.MODE_PAYLOAD_SLOTS,) + tuple(sym.shape), _PAD_BIN,
                      dtype=torch.int32, device=sym.device)
    for k in range(C.MODE_PAYLOAD_SLOTS):
        for m in range(5):
            s = SLOT_STREAM[m][k]
            if s >= 0:
                bins[k] = torch.where(sym == m, C.STREAM_BASE[s] + idx[k], bins[k])
    return bins


def _ref_index_table(width: int):
    """Static maps: payload symbol -> (lag 1..3 | 0) and (ref-index | 0)."""
    offs = _const_offsets(width)

    def split(tbl):
        lag = tuple(o if 1 <= o <= 3 else 0 for o in tbl)
        refi = tuple(0 if 1 <= o <= 3 else offs.index(o) + 1 for o in tbl)
        return lag, refi

    return split(C.back_ref_offsets(width)), split(C.luma_ref_offsets(width)), offs


def assemble_v3(pos, sym, p1, p2, p3, p4, n_pixels: int, width: int, wbits):
    """Slot records in serial order (B, S) -> (rec, dst, (ok_cov, ok_ref)).

    The decoder state machine of ref code.rs:573-684 in slot space: run
    values via digit ordinals, pixel starts via one coverage cumsum
    (`_slot_starts`), transfer forms per mode.  ok_cov: the decoded
    coverage tiles [0, N); ok_ref: every BACK_REF index is < NUM_BACK_REF.
    Coverage sums run in int64 (the JAX int32 sums could wrap on
    adversarial digit chains).  The decode core runs the same steps on the
    compacted real slots."""
    valid = (pos >= 0) & (pos < wbits[:, None])
    start, real, ok_cov = _slot_starts(valid, sym, n_pixels)
    ok_ref = ~(real & (sym == C.PREFIX_BACK_REF) & (p1 >= C.NUM_BACK_REF)).any(dim=1)
    is_pfx = valid & (sym < C.PREFIX_RUN_BASE)
    rec, dst = slot_records(is_pfx, sym, p1, p2, p3, p4, start, real, n_pixels, width)
    return rec, dst, (ok_cov, ok_ref)


def _slot_starts(valid, sym, n_pixels: int):
    """`assemble_v3`'s run values and pixel starts, for the decode core:
    (B, S) valid slots and symbols -> (start (B, S) int64, real (B, S) bool,
    ok_cov (B,)).  Each temporary is freed once the next step has used it
    and the sums run in place: at most about 34 bytes a slot are live with
    the walk's sym/i12/i34 (the running maximum of the digit counts)."""
    N = n_pixels
    is_pfx = valid & (sym < C.PREFIX_RUN_BASE)
    dig_ok = valid & (sym >= C.PREFIX_RUN_BASE)
    # kk: run digits since the last prefix, minus one (a slot's digit count
    # fits int32 while an image has fewer than 2**31 slots)
    kk = torch.cumsum(dig_ok, dim=1, dtype=torch.int32 if sym.shape[1] < 2**31 else torch.int64)
    cd_base = torch.cummax(torch.where(is_pfx, kk, -1), dim=1).values
    dig_ok &= cd_base >= 0
    kk.sub_(cd_base).sub_(1)
    del cd_base
    dig_ok &= (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
    first = kk == 0
    shift = kk.clamp_(0, C.MAX_RUN_DIGITS - 1)
    dv = (sym - C.PREFIX_RUN_BASE).to(torch.int64)
    dv.masked_fill_((shift == C.MAX_RUN_DIGITS - 1) & (dv > 1), 1)
    cov = dv.bitwise_left_shift_(shift.mul_(3)).add_(first)
    del kk, shift, first
    cov.masked_fill_(~dig_ok, 0).add_(is_pfx).clamp_(max=N)  # legit coverage is <= N per slot
    del dig_ok
    start = torch.cumsum(cov, dim=1)
    ok_cov = start[:, -1] >= N
    start.sub_(cov)
    del cov
    return start, is_pfx.logical_and_(start < N), ok_cov


def _compact(real, arrays, fills):
    """Each image's real slots, in order, from column 0 of a (B, K) array,
    K the largest count of any image: (*arrays compacted, live (B, K)
    bool); a column past an image's count holds its array's fill value."""
    B, S = real.shape
    dev = real.device
    counts = real.sum(dim=1)
    K = max(1, int(counts.max()))
    src = torch.nonzero(real.view(-1)).view(-1)
    to = torch.arange(src.numel(), device=dev)
    if B > 1:  # slot j of image b goes to b * K + (j's rank in its image)
        row = torch.div(src, S, rounding_mode="floor")
        to += row * K - (torch.cumsum(counts, 0) - counts)[row]
        del row
    out = []
    for a, fill in zip(arrays, fills):
        o = torch.full((B, K), fill, dtype=a.dtype, device=dev)
        o.view(-1)[to] = a.reshape(-1)[src]
        out.append(o)
    return (*out, torch.arange(K, device=dev)[None] < counts[:, None])


def slot_records(is_pfx, sym, p1, p2, p3, p4, start, real, n_pixels: int, width: int):
    """Packed placement records from decoded pixel slots (element-wise):
    rec = form(3b) | ref-index(4b) | dr,dg,db (8b each, mod 256); dst = the
    pixel a real slot starts at, N for every other slot."""
    N, W = n_pixels, width
    mode = torch.where(is_pfx, sym, 0)
    is_br = mode == C.PREFIX_BACK_REF
    is_rgb = mode == C.PREFIX_RGB
    is_lu = mode == C.PREFIX_COLOR_LUMA
    is_sd = mode == C.PREFIX_SMALL_DIFF
    is_l2 = mode == C.PREFIX_COLOR_LUMA2
    row0 = start < W
    pos0 = start == 0

    (br_lag, br_refi), (lu_lag, lu_refi), _ = _ref_index_table(W)
    lag = torch.where(is_br, _sel(p1, br_lag), torch.where(is_lu, _sel(p1, lu_lag), 0))
    refi = torch.where(is_br, _sel(p1, br_refi), torch.where(is_lu, _sel(p1, lu_refi), 0))

    form = torch.full_like(mode, F_ADD1)
    form = torch.where(is_br | is_lu, torch.where(lag > 0, F_CONST + lag, F_CONST), form)
    form = torch.where(is_sd | is_rgb, torch.where(row0, F_ADD1, F_HALF), form)
    form = torch.where(is_l2, F_HALF, form)
    form = torch.where(is_rgb & pos0, F_CONST, form)
    refi = torch.where(lag > 0, 0, refi)

    lg = p2 - 32
    g2 = p1 - 32
    sd_r = p1 % 7
    sd_rem = (p1 - sd_r) // 7
    sd_g = sd_rem % 7
    sd_b = (sd_rem - sd_g) // 7

    def select(br, lu, l2, sd, default):  # first matching mode wins
        out = torch.where(is_sd, sd, default)
        out = torch.where(is_l2, l2, out)
        out = torch.where(is_lu, lu, out)
        return torch.where(is_br, br, out)

    dr = select(0, p3 - 16 + lg, p2 - 16 + g2, sd_r - 3, p1)
    dg = select(0, lg, g2, sd_g - 3, p2)
    db = select(0, p4 - 16 + lg, p3 - 16 + g2, sd_b - 3, p3)

    rec = form | (refi << 3) | ((dr & 255) << 7) | ((dg & 255) << 15) | ((db & 255) << 23)
    dst = torch.where(real, start, N)
    return rec.to(torch.int32), dst


def place_and_unpack(rec, dst, n_pixels: int, width: int):
    """Scatter packed records (B, S) to raster positions; unpack to
    (form (B, N), delta (B, 3, N) channel-planar, refoff (B, N)).  Real
    slots have unique destinations in [0, N); every other slot lands in the
    spare column N, and a destination outside [0, N] would be dropped (the
    mask stands for JAX's mode="drop")."""
    return _unpack(_place(rec, dst, n_pixels), n_pixels, width)


def _place(rec, dst, n_pixels: int):
    """The scatter of `place_and_unpack`: (B, N + 1) packed records, the
    run-covered default where no real slot lands."""
    N = n_pixels
    keep = (dst >= 0) & (dst <= N)
    base = torch.full((rec.shape[0], N + 1), REC_DEFAULT, dtype=torch.int32, device=rec.device)
    base.scatter_(1, torch.where(keep, dst, N).to(torch.int64), rec)
    return base


def _unpack(base, n_pixels: int, width: int):
    """The unpacking of `place_and_unpack`, one plane at a time."""
    N = n_pixels
    recN = base[:, :N]
    form = recN & 7
    delta = torch.empty((base.shape[0], 3, N), dtype=torch.int32, device=base.device)
    for c, sh in enumerate((7, 15, 23)):
        delta[:, c] = (recN >> sh) & 255
    refoff = _sel((recN >> 3) & 15, (0,) + tuple(_const_offsets(width)))
    return form, delta, refoff


# ---------------------------------------------------------------------------
# Decode core
# ---------------------------------------------------------------------------


def walk_rounds(words, wbits, aff, dD, inc, pfx, *, chunk_bits: int, steps: int, rounds: int,
                marks=None):
    """The decode core's speculative walk: round 1 from the chunk starts,
    each later round from the previous round's exits anchored at bit 0, the
    final round with its records.  Returns (pos, sym, i12, i34, ok_consist,
    ok_cross): the final round's records (B, nch, steps) and the walk
    gates (B,).  Shapes as in `_decode_core_v3`; aff/dD/inc from
    `derive_walk_tables`."""
    B, Wn = words.shape
    dev = words.device
    wpc = chunk_bits // 32
    nch = (Wn - _wrows(chunk_bits)) // wpc
    if nch < 1:
        raise ValueError(f"{Wn} words hold no {chunk_bits}-bit chunk")
    starts = (torch.arange(nch, dtype=torch.int32, device=dev) * chunk_bits)[None, :]
    wbits = wbits.to(torch.int32).contiguous()
    pfx = pfx.contiguous()

    def run(e, records):
        return walk(words, e, aff, dD, inc, pfx, wbits, chunk_bits=chunk_bits, steps=steps,
                    records=records)

    e = starts.expand(B, nch).contiguous()
    for r in range(rounds - 1):
        with span(f"decode3.walk_round{r + 1}", marks):
            ex = run(e, False)[4]
            e = torch.cat([torch.zeros_like(ex[:, :1]), ex[:, :-1]], dim=1)
    with span(f"decode3.walk_round{rounds}", marks):
        pos, sym, i12, i34, ex2 = run(e, True)

    # induction from the bit-0 anchor: every final exit still inside the
    # payload equals the next chunk's entry, and every walked chunk crossed
    # its boundary within the step budget
    wb = wbits[:, None]
    bounds = starts + chunk_bits
    ok_consist = ((ex2[:, :-1] == e[:, 1:]) | (ex2[:, :-1] >= wb)).all(dim=1)
    walked = e < wb
    crossed = ex2 >= torch.minimum(bounds, wb)
    ok_cross = (crossed | ~walked).all(dim=1)
    return pos, sym, i12, i34, ok_consist, ok_cross


def decode_planes_v3(words, wbits, af, present, ib, pfx, sym_tbl, *, n_pixels: int,
                     width: int, chunk_bits: int, steps: int, rounds: int, marks=None, walk_tables=None):
    """The decode core up to the reconstruction: the walk rounds and their
    gates, the slot assembly, the value join, the records and the
    placement.  Returns (form (B, N), delta (B, 3, N), refoff (B, N),
    gates (B, 4) bool), the reconstruction's inputs; see `_decode_core_v3`."""
    B = words.shape[0]
    aff, dD, inc = derive_walk_tables(af, present, ib) if walk_tables is None else walk_tables
    pos, sym, i12, i34, ok_consist, ok_cross = walk_rounds(
        words, wbits, aff, dD, inc, pfx, chunk_bits=chunk_bits, steps=steps, rounds=rounds,
        marks=marks)
    S = pos.shape[1] * steps
    N = n_pixels
    with span("decode3.assemble", marks):
        pos, sym, i12, i34 = (r.view(B, S) for r in (pos, sym, i12, i34))
        valid = (pos >= 0) & (pos < wbits.to(torch.int32)[:, None])
        del pos
        start, real, ok_cov = _slot_starts(valid, sym, N)
        del valid
        # only the real pixels' slots go on, per image, with a hole's symbol
        # and the spare column N past each image's count
        sym, i12, i34, start, live = _compact(real, (sym, i12, i34, start), (C.PREFIX_RUN_BASE, 0, 0, N))
        del real
    with span("decode3.value_join", marks):
        bins = _payload_bins(sym, i12, i34)
        del i12, i34
        syms = cuda_ops.value_join(bins, sym_tbl.contiguous())
        del bins
    with span("decode3.records+place", marks):
        ok_ref = ~(live & (sym == C.PREFIX_BACK_REF) & (syms[0] >= C.NUM_BACK_REF)).any(dim=1)
        rec = torch.empty_like(sym)
        dst = torch.empty_like(start)
        cols = max(1, RECORD_BLOCK // B)
        for a in range(0, sym.shape[1], cols):  # bounds slot_records' temporaries
            c = (slice(None), slice(a, a + cols))
            rec[c], dst[c] = slot_records(live[c], sym[c], *(p[c] for p in syms), start[c], live[c], N, width)
        del sym, syms, start, live
        base = _place(rec, dst, N)
        del rec, dst
        form, delta, refoff = _unpack(base, N, width)
        del base
    return form, delta, refoff, torch.stack([ok_consist, ok_cross, ok_cov, ok_ref], dim=1)


def _decode_core_v3(words, wbits, af, present, ib, pfx, sym_tbl, *, n_pixels: int,
                    width: int, chunk_bits: int, steps: int, rounds: int, marks=None,
                    walk_tables=None):
    """Full device decode of a batch: `decode_planes_v3`, then the row
    reconstruction.

    words (B, Wn) int32 bit patterns (Wn >= nch * chunk_bits/32 + the
    lookahead, zeros past each payload); wbits (B,) int32; af/present/ib
    (B, 10, 32); pfx (B, 1, 16); sym_tbl (B, 858).  Returns (out (B, 3, N)
    uint8 channel-planar, ok (B,), gates (B, 4) bool) with gates =
    [consistency, crossing, coverage, backref-index].  marks: optional list
    receiving (stage, CUDA event) pairs.  walk_tables: the walk's (aff, dD,
    inc) of af/present/ib where the caller built them with the tables
    (`prepare_tables_v3(..., walk=True)`), once for every rung; None
    derives them here (`derive_walk_tables`, one launch a call).

    Past the walk, at most about 34 bytes a slot of the final round are
    live (`_slot_starts`); the value join, the records (in blocks of
    RECORD_BLOCK slots) and the placement see only the real pixels' slots
    (`_compact`), and every array is freed once the next step has used
    it."""
    form, delta, refoff, gates = decode_planes_v3(
        words, wbits, af, present, ib, pfx, sym_tbl, n_pixels=n_pixels, width=width,
        chunk_bits=chunk_bits, steps=steps, rounds=rounds, marks=marks, walk_tables=walk_tables)
    with span("decode3.recon", marks):
        out = recon.reconstruct_rows(form, delta, refoff, width=width)
    return out.to(torch.uint8), gates.all(dim=1), gates


# ---------------------------------------------------------------------------
# Ladder, word capacity, verification
# ---------------------------------------------------------------------------


def run_ladder(call, n: int, *, ladder=LADDER, skip=None, stats=None):
    """Shared retry-ladder orchestration (the JAX `run_ladder`).

    call(rung) -> (ok (n,) bool-ish, aux tuple of per-image arrays, gates or
    None).  Tries each rung in order; aux arrays come from the first rung
    for every image and are overwritten per image by the first rung whose
    gates verified it; `skip`ped images never verify.  Returns (ok (n,)
    np.bool_, merged aux list).  stats receives fallbacks / retries / ok /
    the gates of the last rung."""
    skip = np.zeros(n, bool) if skip is None else np.asarray(skip, bool)
    ok_np = np.zeros(n, bool)
    merged: list | None = None
    retries = 0
    gates_last = None
    for rung in ladder:
        ok, aux, gates = call(rung)
        ok_new = np.asarray(ok) & ~skip
        if gates is not None:
            gates_last = np.asarray(gates)
        with span("decode3.ladder_merge"):
            if merged is None:
                merged = [np.array(a) for a in aux]
                ok_np = ok_new
            else:
                upd = ok_new & ~ok_np
                for m, a in zip(merged, aux):
                    m[upd] = np.asarray(a)[upd]
                ok_np = ok_np | ok_new
        if (ok_np | skip).all():
            break
        retries += 1
    if stats is not None:
        stats["fallbacks"] = int((~ok_np).sum())
        stats["retries"] = retries
        stats["ok"] = [bool(x) for x in ok_np]
        if gates_last is not None:
            stats["gates"] = [[bool(g) for g in row] for row in gates_last]
    return ok_np, (merged if merged is not None else [])


def _wcap_one(max_payload_bytes: int, cfg: WalkCfg) -> int:
    """Word-array length one rung needs: its chunks plus the lookahead
    (no padding of the chunk count to the TPU's block of rows * 128).  The
    chunks cover at most MAX_DEVICE_BITS: a longer payload is never decoded
    on the device."""
    bits = min(max_payload_bytes * 8, MAX_DEVICE_BITS)
    nch = max(1, -(-bits // cfg.chunk_bits))
    return nch * (cfg.chunk_bits // 32) + _wrows(cfg.chunk_bits)


def _words_cap(max_payload_bytes: int, ladder) -> int:
    """Word-array length covering every rung (each rung derives its chunk
    count from it)."""
    return max(_wcap_one(max_payload_bytes, r) for r in ladder)


def _fit_words(words, Wn: int):
    """(B, w) int32 words cut or zero-padded to (B, Wn)."""
    w = words.shape[1]
    return words[:, :Wn].contiguous() if w >= Wn else F.pad(words, (0, Wn - w))


def _raise_if_consistent_but_wrong(ok_np, eq_np) -> None:
    """A gate-consistent decode that differs from the encoder input is a
    kernel defect and must surface loudly, never as a silent fallback."""
    bad = np.asarray(ok_np, bool) & ~np.asarray(eq_np, bool)
    if bad.any():
        raise RuntimeError(
            f"device decode gate-consistent but NOT equal to the original "
            f"(image {int(np.argmax(bad))}): kernel defect, refusing silent fallback"
        )


def _equal_planar(out, flat) -> torch.Tensor:
    """(B,) bool: decoded (B, 3, N) equals the (B, N, 3) original.

    The hook that hands out a round trip's decoded planes: the benchmark's
    round-trip check (`benchmark/calls/roundtrip_batch.py`) replaces this
    module attribute with a wrapper that reads `out`.  So every rung that
    verifies a batch (`_roundtrip_verify_core`, `verify_words_device`) calls
    it by this name, through the module's globals, with the rung's decoded
    (B, 3, N) planes; keep the name and that call."""
    return (out == flat.transpose(1, 2)).flatten(1).all(dim=1)


def verify_words_device(words_dev, totals, lengths, orig_dev, *, n_pixels: int, width: int,
                        skip=None, ladder=LADDER, stats=None):
    """Device-resident round-trip verification: decode straight from the
    encoder's words (B, w_cap) int32 and prove equality with the resident
    (B, N, 3) uint8 originals, rung by rung.  totals (B,) and lengths
    (B, 858) are host arrays; skipped images (their fused encode
    overflowed) are never verified and borrow the first live image's
    tables.  Returns (B,) bool `verified`; a gate-consistent decode that
    differs from the original raises."""
    B = int(words_dev.shape[0])
    skip = np.zeros(B, bool) if skip is None else np.asarray(skip, bool)
    if skip.all():
        if stats is not None:
            stats["fallbacks"] = B
            stats["retries"] = 0
        return np.zeros(B, bool)
    with span("decode3.verify_words_device"):
        donor = int(np.argmin(skip))
        src_rows = np.where(skip, donor, np.arange(B))
        lens_b = np.asarray(lengths, dtype=np.int64)[src_rows]
        for b in range(B):
            if not skip[b]:
                validate_flat_lengths(lens_b[b])
        dev = words_dev.device
        af, pr, ib, pfx, sym_tbl, _, _, *walk_t = prepare_tables_v3(torch.from_numpy(lens_b).to(dev), walk=True)
        tot = np.where(skip, int(totals[donor]), np.asarray(totals)).astype(np.int64)
        wi = _fit_words(words_dev, _words_cap(int(tot.max() + 7) // 8, ladder))
        wbits = torch.from_numpy(tot.astype(np.int32)).to(dev)

        def call(cfg):
            with span("decode3.rung"):
                out, ok, _ = _decode_core_v3(
                    wi, wbits, af, pr, ib, pfx, sym_tbl, n_pixels=n_pixels, width=width,
                    chunk_bits=cfg.chunk_bits, steps=_steps(cfg.chunk_bits, cfg.steps_div),
                    rounds=cfg.rounds, walk_tables=walk_t,
                )
                with span("decode3.sync"):
                    ok = ok.cpu().numpy()
                return ok, (_equal_planar(out, orig_dev).cpu().numpy(),), None

        ok_np, (eq_np,) = run_ladder(call, B, ladder=ladder, skip=skip, stats=stats)
        _raise_if_consistent_but_wrong(ok_np, eq_np)
        return ok_np


# ---------------------------------------------------------------------------
# Fused round trip: encode + device tables + decode + verify
# ---------------------------------------------------------------------------

# Optimistic payload cap for the round trip (bits/pixel); images over it set
# the overflow flag and take the host path like any other overflow.
ROUNDTRIP_CAP_BPP = 16


def roundtrip_cap_words(n_pixels: int) -> int:
    return n_pixels * ROUNDTRIP_CAP_BPP // 32 + 1024


def _roundtrip_verify_core(flat, *, width: int, ndigits_cap: int, w_cap: int, cfg: WalkCfg,
                           marks=None):
    """Encode (B, N, 3) uint8 resident images, build the decode tables from
    the encoder's device lengths, decode from the device-resident words and
    compare with the input, all on the device.

    Returns (words (B, w_cap) int32 bit patterns, small2 (B, 862) int32) with
    small2 = [lengths(858), total_bits, ovf, verified_ok, eq]."""
    N = flat.shape[1]
    words, lengths, totals, ovf = encode_fused_core(
        flat, width=width, ndigits_cap=ndigits_cap, w_cap=w_cap, marks=marks
    )
    with span("decode3.tables", marks):
        af, pr, ib, pfx, sym_tbl, _, tables_ok, *walk_t = prepare_tables_v3(lengths, walk=True)
    wi = _fit_words(words, _wcap_one((32 * (w_cap - 2)) // 8, cfg))
    out, ok, _ = _decode_core_v3(
        wi, totals.to(torch.int32), af, pr, ib, pfx, sym_tbl, n_pixels=N, width=width,
        chunk_bits=cfg.chunk_bits, steps=_steps(cfg.chunk_bits, cfg.steps_div),
        rounds=cfg.rounds, marks=marks, walk_tables=walk_t,
    )
    with span("decode3.equality", marks):
        eq = _equal_planar(out, flat)
    okf = ok & tables_ok & ~ovf & (totals < MAX_DEVICE_BITS)
    small2 = torch.cat(
        [lengths, totals.to(torch.int32)[:, None]]
        + [x.to(torch.int32)[:, None] for x in (ovf, okf, eq)],
        dim=1,
    )
    return words, small2


def roundtrip_verify_fused(flat_dev, *, width: int, w_cap: int | None = None, stats=None,
                           marks=None):
    """Device round trip of a (B, N, 3) uint8 resident batch: the fused
    encode + tables + decode + verify on the fast rung, one fetch of the
    (B, 862) small2; images it cannot verify (payload over the optimistic
    cap excepted) retry through `verify_words_device` on the later rungs.
    An image whose payload has MAX_DEVICE_BITS or more is neither verified
    on the device nor retried: the walk covers only the first
    MAX_DEVICE_BITS.

    Returns (words_dev (B, w_cap) int32 bit patterns, small (B, 860) int32
    numpy — the `encode_fused` layout — and verified (B,) bool).  stats
    receives "retries" (images retried on a later rung) and "fallbacks"
    (images left unverified, overflowing ones included)."""
    B, N, _ = (int(x) for x in flat_dev.shape)
    if w_cap is None:
        w_cap = roundtrip_cap_words(N)
    with span("decode3.roundtrip_verify_fused"):
        words, small2_d = _roundtrip_verify_core(
            flat_dev, width=width, ndigits_cap=3, w_cap=w_cap, cfg=LADDER[0], marks=marks
        )
        with span("decode3.sync"):
            small2 = small2_d.cpu().numpy()
        small = small2[:, :860]
        okf = small2[:, 860].astype(bool)
        eq = small2[:, 861].astype(bool)
        _raise_if_consistent_but_wrong(okf, eq)
        verified = okf & eq
        ovf = small[:, 859].astype(bool)
        retry = ~verified & ~ovf & (small[:, 858] < MAX_DEVICE_BITS)
        if stats is not None:
            stats["retries"] = int(retry.sum())
        if retry.any():
            with span("decode3.robust_retry", marks):
                verified = verified | verify_words_device(
                    words, small[:, 858], small[:, :858], flat_dev, skip=~retry, n_pixels=N,
                    width=width, ladder=LADDER[1:],
                )
    if stats is not None:
        stats["fallbacks"] = int((~verified).sum())
        stats["ok"] = [bool(x) for x in verified]
    return words, small, verified


# ---------------------------------------------------------------------------
# Decode from bytes
# ---------------------------------------------------------------------------


def _parse_batch(datas: list[bytes]):
    """Same-shape `.nice` streams -> (W, H, lengths (B, 858) int64, payloads)."""
    shapes = {headers.parse_file_header(d)[:2] for d in datas}
    if len(shapes) != 1:
        raise ValueError("batch decode requires same-shape streams")
    W, H = next(iter(shapes))
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH}")
    lens, payloads = [], []
    for d in datas:
        if headers.parse_file_header(d)[2] != 3:
            raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
        flat_lengths = headers.parse_stream_headers(d[C.FILE_HEADER_BYTES :])
        validate_flat_lengths(flat_lengths)
        lens.append(flat_lengths)
        payloads.append(d[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(d) - 4])
    return W, H, np.stack(lens).astype(np.int64), payloads


def payload_bits(data: bytes) -> int:
    """The payload bits of a `.nice` stream, from its length alone."""
    return 8 * (len(data) - C.FILE_HEADER_BYTES - C.STREAM_HEADERS_BYTES - 4)


def prepare_batch_args(datas: list[bytes], *, device, ladder=LADDER):
    """Device arrays for `_decode_core_v3` on a same-shape batch: the host
    parses and validates the headers and packs the payload words; the
    lengths are uploaded and the tables built on the device
    (`prepare_tables_v3`, which equals the JAX numpy batch builder).  The
    word array is sized for every rung of `ladder`.  Returns (args, (H, W)).
    A payload of MAX_DEVICE_BITS or more raises: the host decodes it."""
    args, _, shape = _batch_args(datas, device=device, ladder=ladder)
    return args, shape


def _batch_args(datas: list[bytes], *, device, ladder):
    """`prepare_batch_args` with the walk's tables, built in the same launch
    as the rest: (args, (aff, dD, inc), (H, W))."""
    with span("decode3.batch_args"):
        if any(payload_bits(d) >= MAX_DEVICE_BITS for d in datas):
            raise ValueError(f"a payload of {MAX_DEVICE_BITS} bits or more is decoded on the host")
        W, H, lens, payloads = _parse_batch(datas)
        Wn = _words_cap(max(len(p) for p in payloads), ladder)
        words = np.zeros((len(datas), Wn), dtype=np.uint32)
        wbits = np.zeros(len(datas), dtype=np.int32)
        for i, p in enumerate(payloads):
            src = np.frombuffer(p + b"\0" * ((-len(p)) % 4), dtype=">u4")
            words[i, : src.shape[0]] = src
            wbits[i] = len(p) * 8
        af, pr, ib, pfx, sym_tbl, _, _, *walk_t = prepare_tables_v3(torch.from_numpy(lens).to(device), walk=True)
        args = (
            torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(wbits).to(device),
            af, pr, ib, pfx, sym_tbl,
        )
        return args, tuple(walk_t), (H, W)


# Peak device bytes of `_decode_core_v3`, which `decode_batch_v3` reckons
# before it decodes.  Its two phases follow each other: the slot phase
# (the digit attachment of `_slot_starts` beside the walk's records: 35.4
# bytes a slot of the robust rung at 527 M slots on an H100) and the pixel
# phase (value join, records and placement of the compacted slots, at most
# one a pixel: 77 bytes a pixel at the fast rung over 134 M pixels); each
# constant keeps a margin over its measurement.
SLOT_BYTES = 40
PIXEL_BYTES = 84
BUDGET_SHARE = 0.9  # of the card's free memory that a decode may reckon on


def decode_bytes(payload_bytes: int, n_pixels: int, ladder=LADDER) -> int:
    """Reckoned peak device bytes of one image's decode through `ladder`
    in a batch whose longest payload has payload_bytes bytes: its word
    array plus the larger of the slot phase (the rung with the most slots,
    nch x steps) and the pixel phase."""
    Wn = _words_cap(payload_bytes, ladder)
    slots = max((Wn - _wrows(r.chunk_bits)) // (r.chunk_bits // 32) * _steps(r.chunk_bits, r.steps_div)
                for r in ladder)
    return 4 * Wn + max(SLOT_BYTES * slots, PIXEL_BYTES * n_pixels)


def device_budget(device) -> int | None:
    """Bytes a decode may take on `device`: BUDGET_SHARE of the card's free
    memory and of the allocator's cached free blocks; None on the CPU."""
    if device.type != "cuda":
        return None
    with span("decode3.device_budget"):
        free = torch.cuda.mem_get_info(device)[0]
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int(BUDGET_SHARE * (free + cached))


def device_groups(datas: list[bytes], *, device, ladder=LADDER):
    """Split same-shape streams into device batches that fit `device_budget`,
    in order, each as large as the reckoning (`decode_bytes`) allows.
    Returns (groups, to_host): lists of stream indices, and {index: reason}
    for the streams the host decodes: a payload of MAX_DEVICE_BITS or more,
    or one that does not fit the budget alone."""
    with span("decode3.device_groups"):
        shapes = {headers.parse_file_header(d)[:2] for d in datas}
        if len(shapes) != 1:
            raise ValueError("batch decode requires same-shape streams")
        W, H = shapes.pop()
        budget = device_budget(device)
        to_host: dict = {}
        groups: list = []
        cur: list = []
        longest = 0  # payload bytes of the longest stream in cur
        for i, d in enumerate(datas):
            nbytes = payload_bits(d) // 8
            if 8 * nbytes >= MAX_DEVICE_BITS:
                to_host[i] = f"a payload of {8 * nbytes} bits, past MAX_DEVICE_BITS ({MAX_DEVICE_BITS})"
                continue
            if budget is not None:
                alone = decode_bytes(nbytes, H * W, ladder)
                if alone > budget:
                    to_host[i] = (f"its decode needs {alone / 2**30:.2f} GiB of device memory "
                                  f"(reckoned), {budget / 2**30:.2f} GiB are free")
                    continue
                if cur and (len(cur) + 1) * decode_bytes(max(longest, nbytes), H * W, ladder) > budget:
                    groups.append(cur)
                    cur, longest = [], 0
            cur.append(i)
            longest = max(longest, nbytes)
        if cur:
            groups.append(cur)
        return groups, to_host


def decode_batch_v3(datas: list[bytes], *, device, chunk_bits: int | None = None,
                    stats=None) -> list[np.ndarray]:
    """Batched device decode of same-shape `.nice` streams (the JAX
    `decode_batch_jax_v3`): each ladder rung in order; an image no rung
    verifies is decoded by the host codec (`hostref.decode_native`) and
    counted in stats["fallbacks"].  The streams run in device batches that
    fit the card's free memory (`device_groups`, reckoned before anything is
    decoded); a rung runs over every batch before the next rung, so that the
    results and stats equal one batch's.  A stream whose payload has
    MAX_DEVICE_BITS or more (the JAX function's int32 bit count cannot hold
    it), or whose decode does not fit alone, goes to the host before
    anything is packed, counted the same way, and stats["to_host"] lists it
    with the reason.  An explicit chunk_bits sets every rung's chunk size
    (the JAX function drops it for `WalkCfg` rungs).  stats["ok"] and
    stats["gates"] cover the device-decoded streams, in order."""
    if not datas:
        return []
    from nicetpu_torch.hostref import oracle

    ladder = LADDER
    if chunk_bits is not None:
        ladder = tuple(r._replace(chunk_bits=chunk_bits) for r in ladder)
    groups, to_host = device_groups(datas, device=device, ladder=ladder)
    on_dev = [i for g in groups for i in g]
    sub: dict = {"retries": 0}
    decoded = {}
    if on_dev:
        batches = [_batch_args([datas[i] for i in g], device=device, ladder=ladder)[:2] for g in groups]
        W, H, _ = headers.parse_file_header(datas[0])

        def call(cfg):
            with span("decode3.rung"):
                res = []
                for args, walk_t in batches:
                    out, ok, gates = _decode_core_v3(
                        *args, n_pixels=H * W, width=W, chunk_bits=cfg.chunk_bits,
                        steps=_steps(cfg.chunk_bits, cfg.steps_div), rounds=cfg.rounds, walk_tables=walk_t,
                    )
                    with span("decode3.sync"):
                        ok = ok.cpu().numpy()
                    with span("decode3.fetch"):
                        res.append((ok, out.cpu().numpy(), gates.cpu().numpy()))
                    del out
                with span("decode3.fetch"):
                    ok, out, gates = (np.concatenate(r) for r in zip(*res))
                return ok, (out,), gates

        ok_np, (out_np,) = run_ladder(call, len(on_dev), ladder=ladder, stats=sub)
        with span("decode3.to_arrays"):
            decoded = {i: out_np[j].reshape(3, H, W).transpose(1, 2, 0)
                       for j, i in enumerate(on_dev) if ok_np[j]}
    if stats is not None:
        stats.update(sub)
        stats["fallbacks"] = len(datas) - len(decoded)
        if to_host:
            stats["to_host"] = [{"stream": i, "why": why} for i, why in sorted(to_host.items())]
    missing = [i for i in range(len(datas)) if i not in decoded]
    if missing:
        with span("decode3.host_decode"):
            decoded.update((i, oracle.decode_native(datas[i])) for i in missing)
    return [decoded[i] for i in range(len(datas))]
