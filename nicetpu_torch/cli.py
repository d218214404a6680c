"""CLI of the port, with the reference binary's extension dispatch (after
`nicetpu.cli`).

Usage: python -m nicetpu_torch.cli <from> <to> [--backend cuda|cpu|native|spec]
       [--verbose]

`.png -> .nice` encodes; `.nice -> .png` decodes; the suffix is appended to
<to> where it is missing.  The time of each stage is printed; --verbose adds
the StageTimer JSON summary.  Defaults (backend, OMP threads) resolve through
RuntimeConfig / NICETPU_* environment.  The default backend is the card:
without CUDA it is an error, and nothing is written; --backend cpu runs the
kernels' plain PyTorch versions, --backend native the C++ host codec and
--backend spec the numpy reference codec.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="nicetpu_torch", description=__doc__)
    ap.add_argument("src", help="input file (.png or .nice)")
    ap.add_argument("dst", help="output file (.nice or .png)")
    ap.add_argument(
        "--backend",
        default=None,
        choices=["cuda", "cpu", "native", "spec"],
        help="default: RuntimeConfig / NICETPU_BACKEND",
    )
    ap.add_argument(
        "--verbose", action="store_true", help="print the StageTimer JSON summary"
    )
    args = ap.parse_args(argv)

    from nicetpu_torch.config import RuntimeConfig

    cfg = RuntimeConfig.from_env()
    if args.backend is not None:
        cfg.backend = args.backend
    if args.verbose:
        cfg.verbose = True
    cfg.apply()  # OMP threads before the host codec's first use

    from nicetpu_torch import api
    from nicetpu_torch.utils.profiling import StageTimer

    src, dst = args.src, args.dst
    if not src.endswith((".png", ".nice")):
        print("error: source must end in .png or .nice", file=sys.stderr)
        return 2
    try:
        api.backend_target(cfg.backend)
    except (RuntimeError, ValueError) as e:  # no card, or NICETPU_BACKEND unknown
        print(f"error: backend {cfg.backend!r}: {e}", file=sys.stderr)
        return 1

    timer = StageTimer()
    if src.endswith(".png"):
        if not dst.endswith(".nice"):
            dst += ".nice"
        t0 = time.perf_counter()
        with timer.stage("png_read"):
            img = api.imread(src)
        t1 = time.perf_counter()
        with timer.stage("encode"):
            data = api.encode(img, config=cfg)
        t2 = time.perf_counter()
        with timer.stage("write"):
            with open(dst, "wb") as f:
                f.write(data)
        print(f"png read: {1e3 * (t1 - t0):.1f} ms")
        print(f"encode:   {1e3 * (t2 - t1):.1f} ms  ({len(data)} bytes, "
              f"ratio {len(data) / img[:, :, :3].nbytes:.3f})")
        nbytes = img.nbytes
    else:
        if not dst.endswith(".png"):
            dst += ".png"
        with timer.stage("read"):
            with open(src, "rb") as f:
                data = f.read()
        t0 = time.perf_counter()
        with timer.stage("decode"):
            img = api.decode(data, config=cfg)
        t1 = time.perf_counter()
        with timer.stage("png_write"):
            api.imwrite(dst, img)
        t2 = time.perf_counter()
        print(f"decode:    {1e3 * (t1 - t0):.1f} ms")
        print(f"png write: {1e3 * (t2 - t1):.1f} ms")
        nbytes = img.nbytes
    if cfg.verbose:
        print(timer.summary(nbytes))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
