"""Photo patches of mixed sizes cut from the corpus's textures; nothing is
resampled.

config keys: "shapes" ([[height, width], ...]: one set's sizes), "pool"
(a whole number of sets).  content keys: "sources" (corpus names, each at
least the largest side both ways; image k of a set is cut from source k
mod len(sources)), "flips" (bool).  The seed picks each cut's offsets, its
flips and the order within a set; every set holds the configuration's
shapes, so every seed does the same amount of work.
"""

from __future__ import annotations

import numpy as np

from benchmark.seeds import rng


def corpus_names(content: dict) -> list[str]:
    return list(content["sources"])


def make(config: dict, seed: int, corpus: dict) -> list[np.ndarray]:
    content = config["content"]
    shapes = [tuple(s) for s in config["shapes"]]
    sets, rest = divmod(config["pool"], len(shapes))
    if rest or not sets:
        raise ValueError(f"a pool of {config['pool']} is no whole number of sets of {len(shapes)}")
    sources = [corpus[name] for name in content["sources"]]
    for name, src in zip(content["sources"], sources):
        if src.shape[0] < max(h for h, _ in shapes) or src.shape[1] < max(w for _, w in shapes):
            raise ValueError(f"{name} is smaller than the largest shape")
    g = rng(seed, "mixed_patches")
    pool = []
    for _ in range(sets):
        for k in g.permutation(len(shapes)):
            (h, w), src = shapes[k], sources[k % len(sources)]
            y, x = int(g.integers(0, src.shape[0] - h + 1)), int(g.integers(0, src.shape[1] - w + 1))
            patch = src[y : y + h, x : x + w]
            if content.get("flips"):
                if g.integers(0, 2):
                    patch = patch[::-1]
                if g.integers(0, 2):
                    patch = patch[:, ::-1]
            pool.append(np.ascontiguousarray(patch))
    return pool
