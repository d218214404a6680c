"""Real-photo patches cut from the corpus, with seeded flips and in a
seeded order; nothing is resampled.

content keys: "sources" (corpus names, each at least the patch's size),
"grid" ([rows, cols]: the patches of a source start on this grid of
offsets, spread evenly from its top-left to its bottom-right corner),
"flips" (bool).  The pool holds len(sources) x rows x cols patches, the
same ones for every seed, so a seed changes the order and the flips of the
work but not its amount: how long the runs are, and so which rung or route
an image takes, follows the patch.
"""

from __future__ import annotations

import numpy as np

from benchmark.seeds import rng


def corpus_names(content: dict) -> list[str]:
    return list(content["sources"])


def make(config: dict, seed: int, corpus: dict) -> list[np.ndarray]:
    content = config["content"]
    H, W = config["shape"]["height"], config["shape"]["width"]
    rows, cols = content["grid"]
    cuts = []
    for name in content["sources"]:
        src = corpus[name]
        if src.shape[0] < H or src.shape[1] < W:
            raise ValueError(f"{name} is smaller than {H}x{W}")
        for y in np.linspace(0, src.shape[0] - H, rows).astype(int):
            for x in np.linspace(0, src.shape[1] - W, cols).astype(int):
                cuts.append(src[y:y + H, x:x + W])
    if len(cuts) != config["pool"]:
        raise ValueError(f"the grid cuts {len(cuts)} patches, the pool holds {config['pool']}")
    g = rng(seed, "corpus_patches")
    pool = []
    for k in g.permutation(len(cuts)):
        patch = cuts[k]
        if content.get("flips"):
            if g.integers(0, 2):
                patch = patch[::-1]
            if g.integers(0, 2):
                patch = patch[:, ::-1]
        pool.append(np.ascontiguousarray(patch))
    return pool
