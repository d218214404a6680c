"""The reference encoder over row blocks, for rasters the whole-image
reference cannot hold: its `TokenPlan` keeps 16 slots a pixel in several
arrays, tens of GB at 16384 x 16384.  Built from `codec`'s own functions:

  1. each block of rows is tokenized by `codec.tokenize` with the 4 rows
     above it (every predictor reaches at most 3W + 3 pixels back), and
     those rows' tokens are dropped;
  2. the run of a block's last change, which `tokenize` ends at the block's
     end, is carried to the first change of a later block: its digit slots
     are written again as `tokenize` writes them;
  3. one histogram is summed over the blocks (`codec.histogram`) and one set
     of canonical tables built (`huffman.build_all_tables`);
  4. each block's serial tokens are packed by `codec.pack_payload`, and the
     blocks' bits are laid end to end at their running bit offset.

The bytes equal `codec.encode`'s.  The blocks are spread over the host's
cores in plain subprocesses of this module (`python -m
benchmark.reference.blocked`), which keep their blocks' serial tokens
between the count and the pack.  Imports numpy and the reference alone.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading
import traceback

import numpy as np

from benchmark.reference import codec, headers, huffman
from benchmark.reference import constants as C

HALO_ROWS = 4  # rows above a block that its predictors read (3W + 3 pixels)
BLOCK_PIXELS = 1 << 20  # pixels a block holds at most, where the width allows
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ONE_THREAD = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}


def block_rows(width: int) -> int:
    return max(HALO_ROWS, BLOCK_PIXELS // width)


def first_change(flat: np.ndarray, lo: int, hi: int) -> int:
    """The first pixel in [lo, hi) that differs from the one before it (pixel
    0 always counts), or -1 where there is none."""
    if lo == 0:
        return 0
    diff = np.any(flat[lo:hi] != flat[lo - 1 : hi - 1], axis=1)
    k = int(diff.argmax())
    return lo + k if diff[k] else -1


def _carry_run(plan: codec.TokenPlan, p: int, run_len: int) -> None:
    """Pixel p's run digit slots for a run of run_len pixels, as
    `codec.tokenize` writes them."""
    v = max(run_len - 1, 0)
    ndigits = 1 + sum(v >= (1 << (3 * j)) for j in range(1, C.MAX_RUN_DIGITS))
    for j in range(C.MAX_RUN_DIGITS):
        on = run_len > 0 and j < ndigits
        plan.streams[p, 5 + j] = C.SC_PREFIXES if on else 0
        plan.symbols[p, 5 + j] = ((v >> (3 * j)) & 7) + C.PREFIX_RUN_BASE if on else 0
        plan.valid[p, 5 + j] = on


def block_plan(ext: np.ndarray, halo_rows: int, lo: int, tail: int) -> codec.TokenPlan:
    """The tokens of a block's pixels: ext holds the block's rows under
    `halo_rows` rows above it, lo is the block's first pixel in the raster
    and tail the first change after the block (the raster's size where
    there is none)."""
    plan = codec.tokenize(ext)
    h = halo_rows * ext.shape[1]
    plan = codec.TokenPlan(plan.streams[h:], plan.symbols[h:], plan.valid[h:])
    changes = np.flatnonzero(plan.valid[:, 0])
    n = plan.valid.shape[0]
    if changes.size and tail != lo + n:
        p = int(changes[-1])
        _carry_run(plan, p, tail - (lo + p) - 1)
    return plan


def serial_plan(bins: np.ndarray) -> codec.TokenPlan:
    """Serial tokens (flat bins, in order) as a plan of one slot a token:
    stream 0's base is 0, so a token's bin is its symbol there."""
    k = bins.shape[0]
    return codec.TokenPlan(np.zeros((k, 1), np.uint8), bins.reshape(k, 1), np.ones((k, 1), bool))


def pack_words(bins: np.ndarray, flat_lengths: np.ndarray, flat_codes: np.ndarray) -> tuple[int, np.ndarray]:
    """(bits, big-endian words) of serial tokens packed by `codec.pack_payload`
    from bit 0; the bits past the last token are zeros."""
    bits = int(flat_lengths[bins].astype(np.int64).sum())
    out = codec.pack_payload(serial_plan(bins), flat_lengths, flat_codes)
    body = out[: bits // 8 + (1 if bits % 8 else 0)]
    body += bytes(-len(body) % 4)
    return bits, np.frombuffer(body, dtype=">u4").astype(np.uint32)


def stitch(parts: list[tuple[int, np.ndarray]]) -> bytes:
    """The payload of blocks' (bits, words) laid end to end, with the
    5-byte flush tail of `codec.pack_payload`."""
    total = sum(b for b, _ in parts)
    out = np.zeros(total // 32 + 2, dtype=np.uint64)
    base = 0
    for bits, w in parts:
        if bits:
            w = w.astype(np.uint64)
            sw, sb = base >> 5, base & 31
            if sb == 0:
                out[sw : sw + len(w)] |= w
            else:
                out[sw : sw + len(w)] |= w >> np.uint64(sb)
                out[sw + 1 : sw + 1 + len(w)] |= (w << np.uint64(32 - sb)) & np.uint64(0xFFFFFFFF)
        base += bits
    raw = out.astype(">u4").tobytes()
    full = total // 8
    B = raw[full] if total % 8 else 0
    return raw[:full] + bytes([B, B, 0, 0, 0])


class _Worker:
    """One subprocess of this module, spoken to through its pipes."""

    def __init__(self) -> None:
        env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
        self.p = subprocess.Popen([sys.executable, "-m", "benchmark.reference.blocked"], cwd=ROOT,
                                  env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def ask(self, msg):
        pickle.dump(msg, self.p.stdin, protocol=pickle.HIGHEST_PROTOCOL)
        self.p.stdin.flush()
        try:
            kind, val = pickle.load(self.p.stdout)
        except EOFError:
            raise RuntimeError(f"a reference worker exited with code {self.p.wait()}") from None
        if kind != "ok":
            raise RuntimeError(f"a reference worker failed:\n{val}")
        return val

    def close(self) -> None:
        self.p.stdin.close()
        self.p.stdout.close()
        self.p.wait()


def _each(workers: list[_Worker], msgs: list) -> list:
    """Every worker's answer to its message, asked together."""
    out: list = [None] * len(workers)
    errors: list = []

    def one(i: int) -> None:
        try:
            out[i] = workers[i].ask(msgs[i])
        except Exception as e:  # re-raised below, after every worker answered
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def encode(img: np.ndarray, *, rows: int | None = None, procs: int | None = None) -> bytes:
    """The reference encoder's `.nice` bytes of an (H, W, 3) uint8 raster,
    over blocks of `rows` rows (default: about 2**20 pixels a block) in at
    most `procs` subprocesses (default: every core)."""
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, 3) uint8 image")
    H, W, _ = img.shape
    if W < C.MIN_WIDTH:
        raise ValueError(f"width must be >= {C.MIN_WIDTH} (SURVEY A.8.7)")
    rows = rows or block_rows(W)
    if rows < HALO_ROWS:
        raise ValueError(f"a block needs at least {HALO_ROWS} rows")
    img = np.ascontiguousarray(img)
    flat = img.reshape(-1, 3)
    starts = list(range(0, H, rows))
    firsts = [first_change(flat, r * W, min(H, r + rows) * W) for r in starts]
    tails, nxt = [], H * W
    for f in reversed(firsts):
        tails.append(nxt)
        nxt = f if f >= 0 else nxt
    tails.reverse()
    jobs = [(k, img[max(0, r - HALO_ROWS) : r + rows], min(HALO_ROWS, r), r * W, tails[k])
            for k, r in enumerate(starts)]
    workers = [_Worker() for _ in range(max(1, min(procs or cores(), len(jobs))))]
    try:
        shares = [jobs[i :: len(workers)] for i in range(len(workers))]
        counts = np.zeros(C.TOTAL_SYMBOLS, dtype=np.int64)
        for got in _each(workers, [("count", share) for share in shares]):
            counts += got
        flat_lengths, flat_codes, _ = huffman.build_all_tables(counts)
        packed: dict = {}
        for got in _each(workers, [("pack", flat_lengths, flat_codes)] * len(workers)):
            packed.update(got)
    finally:
        for w in workers:
            w.close()
    payload = stitch([packed[k] for k in range(len(jobs))])
    return headers.pack_file_header(W, H, 3) + headers.pack_stream_headers(flat_lengths) + payload


def main() -> int:
    """A worker: ("count", jobs) -> the summed counts of its blocks, whose
    serial tokens it keeps; ("pack", lengths, codes) -> {block: (bits,
    words)}.  Pickles through standard input and output until EOF."""
    kept: dict = {}
    while True:
        try:
            msg = pickle.load(sys.stdin.buffer)
        except EOFError:
            return 0
        try:
            if msg[0] == "count":
                total = np.zeros(C.TOTAL_SYMBOLS, dtype=np.int64)
                for k, ext, halo_rows, lo, tail in msg[1]:
                    plan = block_plan(ext, halo_rows, lo, tail)
                    total += codec.histogram(plan)
                    bins = np.asarray(C.STREAM_BASE, dtype=np.int64)[plan.streams[plan.valid]]
                    kept[k] = (bins + plan.symbols[plan.valid]).astype(np.uint16)
                reply = ("ok", total)
            else:
                _, lengths, codes = msg
                reply = ("ok", {k: pack_words(b, lengths, codes) for k, b in kept.items()})
        except Exception:
            reply = ("error", traceback.format_exc())
        pickle.dump(reply, sys.stdout.buffer, protocol=pickle.HIGHEST_PROTOCOL)
        sys.stdout.buffer.flush()


if __name__ == "__main__":
    sys.exit(main())
