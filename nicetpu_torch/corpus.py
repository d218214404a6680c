"""Streamed corpus encoding with checkpoint/resume and error isolation
(after `nicetpu.corpus`).

  * checkpoint/resume: a JSONL manifest records every completed image
    (path, size, ratio); resuming skips completed entries.
  * failure isolation: one bad image doesn't abort the run: the error is
    recorded in the manifest and the stream continues.  A backend that
    cannot run at all (the card is asked for and absent) is not a bad
    image: it raises before the first one.
  * observability: per-image mode-distribution stats from the encoder's own
    tokenizer and histogram (`stats_from_bitstream`).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from nicetpu_torch.format import constants as C


@dataclass
class CorpusResult:
    total_images: int
    encoded: int
    skipped: int
    failed: int
    raw_bytes: int
    compressed_bytes: int
    seconds: float


def mode_stats(counts: np.ndarray) -> dict:
    """Mode-distribution stats from a flat (858,) histogram.

    The prefix stream (id 1) holds one symbol per encoded pixel plus run
    digits — the same observability the reference's debug counters provide.
    """
    base = C.STREAM_BASE[C.SC_PREFIXES]
    pfx = counts[base : base + 13]
    return {
        "back_ref": int(pfx[C.PREFIX_BACK_REF]),
        "rgb": int(pfx[C.PREFIX_RGB]),
        "luma": int(pfx[C.PREFIX_COLOR_LUMA]),
        "small_diff": int(pfx[C.PREFIX_SMALL_DIFF]),
        "luma2": int(pfx[C.PREFIX_COLOR_LUMA2]),
        "run_digits": {d: int(pfx[C.PREFIX_RUN_BASE + d]) for d in range(8)},
        "total_tokens": int(counts.sum()),
    }


def stats_from_bitstream(data: bytes, *, device=None, config=None) -> dict:
    """Mode stats of an encoded file: decode it, then count the tokens the
    encoder would emit with the port's own tokenizer and histogram (on the
    card, the histogram kernel).  Runs of any length are counted: the
    tokenizer gets every run digit slot."""
    from nicetpu_torch import api
    from nicetpu_torch.kernels import cuda_ops
    from nicetpu_torch.kernels.encode2 import _tokenize_core

    dev = api.target(device, config)
    img = api.decode(data, device=None if isinstance(dev, str) else dev, config=config)
    H, W, _ = img.shape
    flat = torch.from_numpy(np.ascontiguousarray(img).reshape(1, H * W, 3))
    flat = flat.to("cpu" if isinstance(dev, str) else dev)
    bins, _ = _tokenize_core(flat, width=W, ndigits_cap=C.MAX_RUN_DIGITS)
    return mode_stats(cuda_ops.histogram(bins.contiguous())[0].cpu().numpy())


def encode_corpus(
    paths: list[str],
    out_dir: str,
    manifest_path: str | None = None,
    backend: str | None = None,
    resume: bool = True,
) -> CorpusResult:
    """Encode a list of image paths to `<out_dir>/<name>.nice`, streaming,
    with manifest checkpointing and per-image error isolation.

    backend: "cuda", "cpu", "native" or "spec"; None resolves it from the
    NICETPU_BACKEND environment, else the card."""
    from nicetpu_torch import api
    from nicetpu_torch.config import RuntimeConfig

    cfg = RuntimeConfig.from_env() if backend is None else RuntimeConfig.from_env(backend=backend)
    api.backend_target(cfg.backend)  # an absent card raises here, not once per image

    os.makedirs(out_dir, exist_ok=True)
    manifest_path = manifest_path or os.path.join(out_dir, "manifest.jsonl")

    done: set[str] = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("status") == "ok":
                    done.add(rec["path"])

    t0 = time.perf_counter()
    encoded = skipped = failed = raw = comp = 0
    with open(manifest_path, "a") as mf:
        for path in paths:
            if path in done:
                skipped += 1
                continue
            name = os.path.splitext(os.path.basename(path))[0] + ".nice"
            rec: dict = {"path": path, "out": os.path.join(out_dir, name)}
            try:
                img = api.imread(path)
                data = api.encode(img, config=cfg)
                with open(rec["out"], "wb") as f:
                    f.write(data)
                rec.update(
                    status="ok",
                    raw=int(img[:, :, :3].nbytes),
                    compressed=len(data),
                    ratio=round(len(data) / img[:, :, :3].nbytes, 4),
                )
                encoded += 1
                raw += rec["raw"]
                comp += rec["compressed"]
            except Exception as e:  # isolate per-image failures
                rec.update(status="error", error=f"{type(e).__name__}: {e}")
                failed += 1
            mf.write(json.dumps(rec) + "\n")
            mf.flush()
    return CorpusResult(
        total_images=len(paths),
        encoded=encoded,
        skipped=skipped,
        failed=failed,
        raw_bytes=raw,
        compressed_bytes=comp,
        seconds=time.perf_counter() - t0,
    )
