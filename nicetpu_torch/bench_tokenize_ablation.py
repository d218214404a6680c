"""What each part of the tokenizer kernel's design buys, on the card.

    python3 -m nicetpu_torch.bench_tokenize_ablation [--reps R]

The committed `csrc/tokenize_kernels.cu` and variants made from edited
copies of it are each built by nvcc with the library's own flags into
`_build/tokenize_ablation/` and timed, in turns (the committed source first
and last), at the three shapes the card times the kernel at: 8 `make_image`
512x512 images at 3 and at 11 run digits, and one 4096x4096 image at 3
(CUDA events over `reps` calls of memset and launch after a warm-up).
Every variant but the timing-only ones is held bit for bit against the
plain version.  Variants:
  committed      the kernel as it stands;
  pixel_staging  the probes' pixels staged one at a time by three byte
                 loads, as where the raster is not word-aligned, in place
                 of four pixels from three aligned words;
  six_blocks     __launch_bounds__ asking for six resident blocks an SM;
  half_spans     512-pixel spans (two rounds of 256 threads), not 1,024;
  no_cascade     (timing only) no mode cascade: the staging, the schedule
                 and the stores alone;
  no_stores      (timing only) no stores of the bins to device memory.
One JSON line a variant (ms at each shape, registers, exact at each shape,
the card's name and power limit); exits non-zero without a card, or where
a variant that should be exact is not.
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
from nicetpu_torch.bench_huffman_ablation import cuda_ms
from nicetpu_torch.kernels import build

SPAN = "constexpr int kRounds = 4;"
CASCADE = ("      over |= edge ? cascade<kCap, true>(stage, o, p, pos, W, next, invalid, out)\n"
           "                   : cascade<kCap, false>(stage, o, p, pos, W, next, invalid, out);\n")
STORE = "        reinterpret_cast<int4*>(dst)[chunk] =\n"

# variant -> (edits as (old, new) pairs, pixels a span, whether its outputs must be exact)
VARIANTS = {
    "committed": ((), 1024, True),
    "pixel_staging": ((("  if (reinterpret_cast<uintptr_t>(x) & 3) {", "  if (true) {"),), 1024, True),
    "six_blocks": ((("__launch_bounds__(kThreads) tokenize_kernel(", "__launch_bounds__(kThreads, 6) tokenize_kernel("),),
                   1024, True),
    "half_spans": (((SPAN, "constexpr int kRounds = 2;"),), 512, True),
    "no_cascade": (((CASCADE, "      out[0] = next;\n      for (int q = 1; q < S; ++q) out[q] = invalid;\n"),), 1024,
                   False),
    "no_stores": (((STORE, "        if (chunk < 0) reinterpret_cast<int4*>(dst)[chunk] =\n"),), 1024, False),
}


def variant_source(name: str) -> str:
    """The kernel source with the variant's edits; each edit must apply once."""
    with open(os.path.join(build.CSRC, "tokenize_kernels.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer applies to tokenize_kernels.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple[ctypes.CDLL, str]:
    """Build one variant into `_build/tokenize_ablation/<name>/`; return the
    loaded library and ptxas's register lines of the tokenizer kernels at 3
    and 11 run digits."""
    out = os.path.join(build.BUILD_DIR, "tokenize_ablation", name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "tokenize_kernels.cu"), "w") as f:
        f.write(variant_source(name))
    shutil.copy(os.path.join(build.CSRC, "common.cuh"), out)
    lib = os.path.join(out, "lib.so")
    res = subprocess.run([build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-Xptxas", "-v", "-shared", "-o", lib, os.path.join(out, "tokenize_kernels.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    regs, entry = [], ""
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "registers" in line and ("ILi3E" in entry or "ILi11E" in entry):
            regs.append(line.split(":", 1)[1].strip())
    handle = ctypes.CDLL(os.path.abspath(lib))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.nt_tokenize_bins.argtypes = [vp, vp, i32, vp, vp, i64, i64, i32, i64, i64, i64, i64, i64, i32, i32, i32,
                                        i32, vp]
    handle.nt_tokenize_bins.restype = i32
    return handle, "; ".join(regs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tokenize_ablation needs a CUDA device", file=sys.stderr)
        return 1
    from nicetpu_torch import pipeline
    from nicetpu_torch.kernels import encode2
    from nicetpu_torch.kernels import tokenize as tok

    dev = torch.device("cuda", 0)
    main_batch = pipeline.upload_batch([make_image(512, 512, s) for s in range(8)], dev)
    big = pipeline.upload_batch([make_image(4096, 4096, 99)], dev)
    shapes = {"512x512x8_cap3": (main_batch, 512, 3), "512x512x8_cap11": (main_batch, 512, 11),
              "4096x4096_cap3": (big, 4096, 3)}
    want = {k: tok.tokenize_bins_plain(x, width=w, halo=0, g0=0, n_total=x.shape[1], ndigits_cap=cap,
                                       invalid_bin=encode2.INVALID_BIN) for k, (x, w, cap) in shapes.items()}
    card, failed = card_line(), []
    for name in [*VARIANTS, "committed"]:
        lib, regs = build_variant(name)
        span = VARIANTS[name][1]
        line = {"variant": name, "ms": {}, "exact": {}, "regs": regs, "card": card}
        for key, (x, width, cap) in shapes.items():
            B, n = x.shape[0], x.shape[1]
            bins = torch.empty(B, n * (5 + cap), dtype=torch.int32, device=dev)
            ticket_at = -(-B // 8) * 8
            scratch = torch.empty(ticket_at + 4 * (1 + B * -(-n // span)), dtype=torch.uint8, device=dev)
            stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

            def call():
                err = lib.nt_tokenize_bins(x.data_ptr(), None, 0, bins.data_ptr(), scratch.data_ptr(),
                                           scratch.numel(), ticket_at, B, n, 0, n, 0, n, width, cap,
                                           encode2.INVALID_BIN, dev.index or 0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")

            line["ms"][key] = cuda_ms(call, args.reps)
            got = (bins, scratch[:B].view(torch.bool))
            line["exact"][key] = all(torch.equal(g, w) for g, w in zip(got, want[key]))
        if VARIANTS[name][2] and not all(line["exact"].values()):
            failed.append(name)
        print(json.dumps(line), flush=True)
    if failed:
        print(f"not exact: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
