"""Sharded `.nice` decode over `torch.distributed` ranks.

Counterpart of `nicetpu/dist/sharded_decode.py`, in two shardings:

* **Single raster** (`decode_sharded`): one bitstream decoded across the
  ranks.  The speculative chunk walk is sharded by chunk ranges: each rank
  holds only its slice of the payload words plus the walk's lookahead and
  walks its chunks with `chunk0`/`bit_base` (the walk kernel's shard
  offsets); between rounds each rank's last exit moves forward to the next
  rank (`Comm.ppermute`), and the gates check the shard boundary the same
  way.  Slot assembly uses local cumsums and all-gathered per-shard totals
  for the global offsets (digit count, coverage) and a running maximum that
  carries across shards for the digit -> pixel attachment.  The records of
  real pixels are all-gathered and each rank keeps its own row block; the
  reconstruction then runs as a carry pipeline: rank d receives the four
  rows above its block from rank d - 1, runs the reconstruction kernel once
  with that carry (`prev4`), and sends its own last four rows on.  (JAX's
  masked loop computes every block on every device; the result is the
  same.)  The blocks are then gathered: on every rank (`decode_sharded`),
  or on rank 0 only (`multihost.decode_multihost`).

* **Batch** (`decode_batch_sharded`): each rank decodes its share of a
  same-shape batch with `decode3.decode_batch_v3` and its ladder; the
  arrays are gathered in order.  No collectives run inside the decode.

Nothing falls back quietly: a raster whose gates fail, or whose geometry
cannot be split (H % n, fewer than 4 rows a rank, W < MIN_WIDTH), is decoded
by `hostref.decode_native` and counted in stats["fallbacks"].  The default
walk configuration is the ladder's robust rung (`LADDER[-1]`, 4096-bit
chunks), not the JAX module's 2048-bit `CHUNK_BITS` alias.  Coverage sums
run in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from nicetpu_torch.api import _resolve_device
from nicetpu_torch.dist.comm import Comm
from nicetpu_torch.format import constants as C
from nicetpu_torch.format import headers
from nicetpu_torch.format.huffman import validate_flat_lengths
from nicetpu_torch.hostref import oracle
from nicetpu_torch.kernels import cuda_ops, decode3, recon
from nicetpu_torch.utils.profiling import MarkedStageTimer

SHARD_ALIGN = 8  # chunks a rank rounds up to: the JAX walk's block on its jnp path


def shard_geometry(wbits: int, n: int, cfg: decode3.WalkCfg) -> tuple[int, int]:
    """(nlc, steps): chunks a rank and the step budget for a payload of
    wbits bits over n ranks, as `build_sharded_decode` computes them on the
    JAX package's CPU mesh, so that both packages walk the same slices."""
    nch = max(1, -(-wbits // cfg.chunk_bits))
    nlc = -(-nch // n)
    nlc = -(-nlc // SHARD_ALIGN) * SHARD_ALIGN
    return nlc, decode3._steps(cfg.chunk_bits, cfg.steps_div)


def shard_words(payload: bytes, rank: int, nlc: int, chunk_bits: int) -> np.ndarray:
    """A rank's slice of the payload words: its nlc chunks plus the walk's
    lookahead, zeros past the payload; (nlc * chunk_bits/32 + wrows,) uint32."""
    wpc = chunk_bits // 32
    n_words = nlc * wpc + decode3._wrows(chunk_bits)
    lo = rank * nlc * wpc
    src = np.frombuffer(payload[4 * lo : 4 * (lo + n_words)], dtype=np.uint8)
    out = np.zeros(4 * n_words, dtype=np.uint8)
    out[: src.size] = src
    return out.view(">u4").astype(np.uint32)


def _walk_shard(words, wbits, tables, comm: Comm, *, nlc: int, cfg, steps: int, clock):
    """The speculative rounds over this rank's chunks, entries moving forward
    across the shard boundary between rounds.  Returns the final round's
    records, its entries e and exits, and the previous rank's final exit."""
    aff, dD, inc, pfx = tables
    dev = words.device
    chunk0 = comm.rank * nlc
    kw = dict(chunk_bits=cfg.chunk_bits, steps=steps, chunk0=chunk0,
              bit_base=chunk0 * cfg.chunk_bits)
    # round 1 from the chunk starts; rank 0's first entry is the anchor, bit 0
    e = ((chunk0 + torch.arange(nlc, dtype=torch.int32, device=dev)) * cfg.chunk_bits)[None]
    for _ in range(cfg.rounds - 1):
        ex = decode3.walk(words, e, aff, dD, inc, pfx, wbits, records=False, **kw)[4]
        e = torch.cat([comm.ppermute(ex[:, -1:]), ex[:, :-1]], dim=1).contiguous()
    pos, sym, i12, i34, ex2 = decode3.walk(words, e, aff, dD, inc, pfx, wbits, **kw)
    prev_exit = comm.ppermute(ex2[:, -1:])[0, 0]
    clock.mark("walk_rounds")
    return (pos, sym, i12, i34), e[0], ex2[0], prev_exit


def _decode_block(data: bytes, comm: Comm, device: torch.device, cfg, stats):
    """This rank's (3, n_local) uint8 row block, or None on every rank where
    the gates failed."""
    W, H, _ = headers.parse_file_header(data)
    n, rank = comm.size, comm.rank
    N = H * W
    n_local = (H // n) * W
    clock = MarkedStageTimer(stats, device)
    flat_lengths = headers.parse_stream_headers(data[C.FILE_HEADER_BYTES :])
    validate_flat_lengths(flat_lengths)
    lens = torch.from_numpy(flat_lengths.astype(np.int64)[None]).to(device)
    af, pr, ib, pfx, sym_tbl, _, _ = decode3.prepare_tables_v3(lens)
    aff, dD, inc = decode3.derive_walk_tables(af, pr, ib)
    payload = data[C.FILE_HEADER_BYTES + C.STREAM_HEADERS_BYTES : len(data) - 4]
    wbits = len(payload) * 8
    nlc, steps = shard_geometry(wbits, n, cfg)
    words = torch.from_numpy(shard_words(payload, rank, nlc, cfg.chunk_bits).view(np.int32))
    words = words[None].to(device)
    wb = torch.tensor([wbits], dtype=torch.int32, device=device)
    clock.mark("tables")

    recs, e, ex2, prev_exit = _walk_shard(
        words, wb, (aff, dD, inc, pfx.contiguous()), comm, nlc=nlc, cfg=cfg, steps=steps, clock=clock
    )
    # gates: the single-device logic, plus the shard boundary
    starts = (rank * nlc + torch.arange(nlc, device=device)) * cfg.chunk_bits
    ok_in = ((ex2[:-1] == e[1:]) | (ex2[:-1] >= wbits)).all()
    first_ok = (prev_exit == e[0]) | (prev_exit >= wbits) | (rank == 0)
    crossed = ex2 >= torch.clamp(starts + cfg.chunk_bits, max=wbits)
    ok_walk = ok_in & first_ok & (crossed | (e >= wbits)).all()

    # slot-space assembly with cross-shard offsets (int64)
    pos, sym, i12, i34 = (r.reshape(-1) for r in recs)
    valid = (pos >= 0) & (pos < wbits)
    is_pfx = valid & (sym < C.PREFIX_RUN_BASE)
    is_dig = valid & (sym >= C.PREFIX_RUN_BASE)
    cd_loc = torch.cumsum(is_dig.to(torch.int64), dim=0)
    m_loc = torch.where(is_pfx, cd_loc, -1).max()
    # one all-gather: [walk ok, digits, last prefix's digit count]
    g1 = comm.all_gather(torch.stack([ok_walk.to(torch.int64), cd_loc[-1], m_loc]))
    ok = bool(g1[:, 0].all())
    offs_cd = torch.cumsum(g1[:, 1], dim=0) - g1[:, 1]
    allm = torch.where(g1[:, 2] >= 0, g1[:, 2] + offs_cd, -1)
    prevm = allm[:rank].max() if rank > 0 else torch.tensor(-1, device=device)
    cd = cd_loc + offs_cd[rank]
    cd_base = torch.maximum(torch.cummax(torch.where(is_pfx, cd, -1), dim=0).values, prevm)
    kk = cd - cd_base - 1
    dig_ok = is_dig & (cd_base >= 0) & (kk >= 0) & (kk < C.MAX_RUN_DIGITS)
    kcl = kk.clamp(0, C.MAX_RUN_DIGITS - 1)
    dv = (sym - C.PREFIX_RUN_BASE).to(torch.int64)
    dv = torch.where(kcl == C.MAX_RUN_DIGITS - 1, dv.clamp(max=1), dv)
    cov = is_pfx.to(torch.int64) + torch.where(dig_ok, (dv << (3 * kcl)) + (kk == 0), 0)
    cov = cov.clamp(max=N)
    inc_loc = torch.cumsum(cov, dim=0)
    g2 = comm.all_gather(inc_loc[-1:])[:, 0]
    start = inc_loc - cov + g2[:rank].sum()  # the coverage of the ranks before
    real = is_pfx & (start < N)
    ok = ok and int(g2.sum()) >= N

    # payload symbols and packed placement records
    bins = decode3._payload_bins(sym[None], i12[None], i34[None])
    syms = cuda_ops.value_join(bins, sym_tbl.contiguous())[:, 0]
    rec, dst = decode3.slot_records(is_pfx, sym, *syms, start, real, N, W)
    ok_ref = ~(real & (sym == C.PREFIX_BACK_REF) & (syms[0] >= C.NUM_BACK_REF)).any()
    keep = torch.nonzero(real).reshape(-1)
    g3 = comm.all_gather(torch.stack([ok_ref.to(torch.int64), torch.tensor(keep.numel(), device=device)]))
    clock.mark("assembly")
    if not (ok and bool(g3[:, 0].all())):
        return None

    # the records of real pixels, all-gathered; this rank keeps its rows
    k_max = max(1, int(g3[:, 1].max()))
    mine = torch.full((2, k_max), N, dtype=torch.int32, device=device)
    mine[0, : keep.numel()] = rec[keep]
    mine[1, : keep.numel()] = dst[keep].to(torch.int32)
    allrec = comm.all_gather(mine)
    clock.mark("records_all_gather")
    rec_g, dst_g = allrec[:, 0].reshape(-1), allrec[:, 1].reshape(-1).to(torch.int64)
    base = rank * n_local
    ours = (dst_g >= base) & (dst_g < base + n_local)
    form, delta, refoff = decode3.place_and_unpack(
        rec_g[None], torch.where(ours, dst_g - base, n_local)[None], n_local, W
    )

    # the carry pipeline: the four rows above from rank d - 1, one kernel
    # run, the last four rows on to rank d + 1
    carry = comm.recv_prev(torch.zeros(1, 3, 4 * W, dtype=torch.int32, device=device))
    clock.mark("carry_wait")
    out, tail = recon.reconstruct_rows(form, delta, refoff, width=W, prev4=carry.contiguous())
    clock.mark("recon")
    comm.send_next(tail)
    return out[0].to(torch.uint8)


def decode_across(data: bytes, comm: Comm, device: torch.device, *, everywhere: bool,
                  cfg: decode3.WalkCfg | None = None, stats=None) -> np.ndarray | None:
    """Decode one `.nice` raster across the ranks of `comm`; every rank
    passes the same bytes.  Returns the (H, W, 3) uint8 raster on every rank
    (everywhere=True) or on rank 0 only (None elsewhere)."""
    W, H, channels = headers.parse_file_header(data)
    if channels != 3:
        raise ValueError("only channels=3 decode is defined (SURVEY A.8.3)")
    if stats is not None:
        stats.setdefault("fallbacks", 0)
    cfg = cfg or decode3.LADDER[-1]
    unshardable = H % comm.size != 0 or H // comm.size < 4 or W < C.MIN_WIDTH
    block = None if unshardable else _decode_block(data, comm, device, cfg, stats)
    if block is None:
        if stats is not None:
            stats["fallbacks"] += 1
        return oracle.decode_native(data) if everywhere or comm.rank == 0 else None
    clock = MarkedStageTimer(stats, device)
    blocks = comm.all_gather(block) if everywhere else comm.gather_root(block)
    clock.mark("stitch")
    if blocks is None:
        return None
    planar = blocks.permute(1, 0, 2).reshape(3, H, W)
    return planar.permute(1, 2, 0).cpu().numpy()


def decode_sharded(data: bytes, *, device="cuda", group=None, cfg: decode3.WalkCfg | None = None,
                   stats: dict | None = None) -> np.ndarray:
    """Decode one `.nice` stream across the ranks of `group` (the default
    group if None): call it on every rank with the same bytes; every rank
    returns the (H, W, 3) uint8 raster.

    device: "cuda" (the rank's current CUDA device; raises without CUDA) or
    "cpu" (the kernels' plain versions).  cfg: the walk configuration
    (default the robust rung `decode3.LADDER[-1]`).  stats: optional dict;
    receives "fallbacks" (1 when the host decoder served the raster) and
    "stages" (host-clock seconds per stage of this rank)."""
    return decode_across(data, Comm(group), _resolve_device(device), everywhere=True, cfg=cfg,
                         stats=stats)


def decode_batch_sharded(datas: list[bytes], *, device="cuda", group=None,
                         stats: dict | None = None) -> list[np.ndarray]:
    """Decode a same-shape batch, len(datas) / n images a rank (call it on
    every rank with the same list); every rank returns all the arrays, in
    order.  Each rank runs `decode3.decode_batch_v3` (the retry ladder, then
    the host decoder); stats receives the sums over the ranks of "retries"
    and "fallbacks"."""
    comm = Comm(group)
    n = comm.size
    if len(datas) % n:
        raise ValueError(f"batch size must be a multiple of {n} ranks")
    k = len(datas) // n
    dev = _resolve_device(device)
    sub: dict = {}
    arrs = decode3.decode_batch_v3(datas[comm.rank * k : (comm.rank + 1) * k], device=dev, stats=sub)
    gathered = comm.all_gather(torch.from_numpy(np.stack(arrs)))
    counts = comm.psum(torch.tensor([sub.get("retries", 0), sub.get("fallbacks", 0)]))
    if stats is not None:
        stats["retries"] = stats.get("retries", 0) + int(counts[0])
        stats["fallbacks"] = stats.get("fallbacks", 0) + int(counts[1])
    return [a.numpy() for a in gathered.reshape(n * k, *gathered.shape[2:])]
