"""A tiny copy of the benchmark for CPU tests: the benchmark's folder
copied under a temporary root, configurations cut to a few small images,
the program's package linked beside it, and the same BENCHMARK.json."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")

TINY = {
    "kodak24": {"shape": {"height": 16, "width": 24, "channels": 3}, "warmup_calls": 1,
                "trace_calls": 2},
    "raster4096": {"shape": {"height": 192, "width": 192, "channels": 4}, "warmup_calls": 1,
                   "trace_calls": 1},
}
TINY_CONTENT = {
    "raster4096": {"photo_tile": 32, "header_px": 30, "sidebar_px": 40, "margin_px": 4,
                   "card_heights": [50, 40, 40], "gradient_px": 6},
}


def make(tmp: str) -> str:
    """A root under tmp holding the tiny benchmark; returns the root."""
    root = os.path.join(tmp, "root")
    os.makedirs(root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "nicetpu_torch"), os.path.join(root, "nicetpu_torch"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name, cut in TINY.items():
        path = os.path.join(root, "benchmark", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(cut)
        cfg["content"].update(TINY_CONTENT.get(name, {}))
        with open(path, "w") as f:
            json.dump(cfg, f)
    return root
