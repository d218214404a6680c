"""What each part of the `huffman_tables` kernel's design buys, on the card.

    python3 -m nicetpu_torch.bench_huffman_ablation [--reps R]

The committed `csrc/huffman_kernels.cu` and variants made from edited
copies of it are each built by nvcc with the library's own flags into
`_build/ablation/` and timed, in turns, on the counts of B = 1, 8 and 32
`make_image` 512x512 images (CUDA events over `reps` launches after a
warm-up); every variant but one is held bit for bit against the plain
version.  Variants:
  committed        the kernel as it stands (timed first and last);
  equality_tests   the int-key path's slot and symbol updates as equality
                   tests and selects, as the int64 path makes them;
  no_symbol_moves  no symbol updates in the merge loop (timing only: the
                   lengths are wrong), what those updates cost;
  stream_fastest   grid (10, B): the blocks of one image, stream by
                   stream, dispatched one after another.
One JSON line a variant (ms at each B, registers, exact at each B, the
card's name and power limit); exits non-zero without a card, or where a
variant that should be exact is not.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from nicetpu_torch.bench import card_line, make_image
from nicetpu_torch.kernels import build

SIZES = (1, 8, 32)
SIDE = 512

NARROW_SLOT = """    const int not_ab = (kb - s) >> 31, not_a = (ka - s) >> 31;  // all ones, or 0
    const int x = (s & not_ab) | (kDead & ~not_ab);
    return (x & not_a) | (merged & ~not_a);
"""
NARROW_MOVE = """    const int not_ab = (kb - node) >> 31;
    len += 1 + not_ab;
    node = (node & not_ab) | (merged & ~not_ab);
"""
LOOP_MOVE = "    move_symbols<KT>(node, len, pa, pb, pm);  // the previous step's, while the minimum is in flight\n"
GRID = ("  const int s = blockIdx.y;\n  const long long img = blockIdx.x;\n",
        "const dim3 grid(B, kStreams);")

# variant -> (edits as (old, new) pairs, whether its outputs must be exact)
VARIANTS = {
    "committed": ((), True),
    "equality_tests": (((NARROW_SLOT, "    return s == ka ? merged : (s == kb ? kDead : s);\n"),
                        (NARROW_MOVE, "    const bool under = node == ka || node == kb;\n"
                                      "    len += under;\n    node = under ? merged : node;\n")), True),
    "no_symbol_moves": (((LOOP_MOVE, ""),), False),
    "stream_fastest": (((GRID[0], "  const int s = blockIdx.x;\n  const long long img = blockIdx.y;\n"),
                        (GRID[1], "const dim3 grid(kStreams, B);")), True),
}


def variant_source(name: str) -> str:
    """The kernel source with the variant's edits; each edit must apply once."""
    with open(os.path.join(build.CSRC, "huffman_kernels.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer applies to huffman_kernels.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple[ctypes.CDLL, str]:
    """Build one variant into `_build/ablation/<name>/`; return the loaded
    library and ptxas's register lines."""
    out = os.path.join(build.BUILD_DIR, "ablation", name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "huffman_kernels.cu"), "w") as f:
        f.write(variant_source(name))
    shutil.copy(os.path.join(build.CSRC, "common.cuh"), out)
    lib = os.path.join(out, "lib.so")
    res = subprocess.run([build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-Xptxas", "-v", "-shared", "-o", lib, os.path.join(out, "huffman_kernels.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    regs = "; ".join(line.split(":", 1)[1].strip() for line in res.stderr.splitlines() if "registers" in line)
    handle = ctypes.CDLL(os.path.abspath(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    handle.nt_huffman_tables.argtypes = [vp, i32, vp, vp, vp, i32, i32, vp]
    handle.nt_huffman_tables.restype = i32
    return handle, regs


def cuda_ms(fn, reps: int) -> float:
    """Mean ms a call over `reps` calls after a warm-up, by CUDA events; the
    stream first spins about 10 ms so that the launches queue ahead."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_huffman_ablation needs a CUDA device", file=sys.stderr)
        return 1
    from nicetpu_torch import pipeline
    from nicetpu_torch.kernels import cuda_ops, encode2, huffman_dev

    dev = torch.device("cuda", 0)
    flat = pipeline.upload_batch([make_image(SIDE, SIDE, s) for s in range(max(SIZES))], dev)
    counts = cuda_ops.histogram(encode2._tokenize_core(flat, width=SIDE, ndigits_cap=3)[0])
    want = {b: huffman_dev.build_tables_device_plain(counts[:b]) for b in SIZES}
    card, failed = card_line(), []
    for name in [*VARIANTS, "committed"]:
        lib, regs = build_variant(name)
        line = {"variant": name, "ms_at_B": {}, "exact_at_B": {}, "regs": regs, "card": card}
        for b in SIZES:
            cb = counts[:b].contiguous()
            lengths = torch.empty(b, cb.shape[1], dtype=torch.int32, device=dev)
            codes = torch.empty_like(lengths)
            ovf = torch.empty(b, 10, dtype=torch.bool, device=dev)
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

            def call():
                err = lib.nt_huffman_tables(cb.data_ptr(), 0, lengths.data_ptr(), codes.data_ptr(),
                                            ovf.data_ptr(), b, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            line["ms_at_B"][b] = cuda_ms(call, args.reps)
            got = (lengths, codes, ovf.any(dim=1))
            line["exact_at_B"][b] = all(torch.equal(g, w) for g, w in zip(got, want[b]))
        if VARIANTS[name][1] and not all(line["exact_at_B"].values()):
            failed.append(name)
        print(json.dumps(line), flush=True)
    if failed:
        print(f"not exact: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
