"""Satellite-style mosaics drawn from the seed, after the tiles of NASA's
Blue Marble Next Generation (visibleearth.nasa.gov, 21600 x 21600 RGB8 a
tile): a square grid of square tiles, land cut from the corpus's
photographic textures and sea as smooth gradients under sensor noise.

Land tiles are `tile`-sized cuts of the "land_sources" on the grid of
their own size (a 1024 x 1024 source gives one cut, soccer0's 2048 x 2048
four), the cuts taken in a seeded order, each as often as the others, with
seeded flips.  A fixed share of the tiles, "sea_share" of them rounded, is
sea: a seeded base colour, a seeded linear gradient of up to
"sea_gradient" levels across the tile (a row's and a column's share
rounded apart), and uniform noise of +-"sea_noise"
levels a channel.  Which tiles are sea is seeded.  So every seed draws the
same amount of each kind of content, and a seed changes where it lies.
Nothing is resampled.

content keys: "grid" (tiles a side), "tile" (pixels a side),
"land_sources" (corpus names, each at least "tile" on each side),
"sea_share", "sea_gradient", "sea_noise".
"""

from __future__ import annotations

import numpy as np

from benchmark.seeds import rng


def corpus_names(content: dict) -> list[str]:
    return list(content["land_sources"])


def _cuts(content: dict, corpus: dict) -> list[np.ndarray]:
    t = content["tile"]
    out = []
    for name in content["land_sources"]:
        src = corpus[name]
        if src.shape[0] < t or src.shape[1] < t:
            raise ValueError(f"{name} is smaller than {t}x{t}")
        for y in range(0, src.shape[0] - t + 1, t):
            for x in range(0, src.shape[1] - t + 1, t):
                out.append(src[y:y + t, x:x + t, :3])
    return out


def _sea(g, content: dict) -> np.ndarray:
    t, amp, noise = content["tile"], content["sea_gradient"], content["sea_noise"]
    base = np.array([g.integers(8, 40), g.integers(30, 80), g.integers(70, 140)], np.int16)
    angle, depth = g.uniform(0, 2 * np.pi), g.uniform(0.3, 1.0) * amp / t
    weight = np.array([0.4, 0.7, 1.0])  # the blue deepens most
    steps = np.arange(t)[:, None] * weight
    across = np.rint(np.cos(angle) * depth * steps).astype(np.int16)  # (t, 3), along a row
    down = np.rint(np.sin(angle) * depth * steps).astype(np.int16)  # (t, 3), down a column
    px = base + across[None, :, :] + down[:, None, :]
    px += g.integers(-noise, noise + 1, (t, t, 3), dtype=np.int8)
    return np.clip(px, 0, 255).astype(np.uint8)


def make(config: dict, seed: int, corpus: dict) -> list[np.ndarray]:
    content = config["content"]
    n, t = content["grid"], content["tile"]
    H, W = config["shape"]["height"], config["shape"]["width"]
    if (H, W) != (n * t, n * t):
        raise ValueError(f"a {n}x{n} grid of {t}-pixel tiles is not {H}x{W}")
    cuts = _cuts(content, corpus)
    g = rng(seed, "mosaic")
    pool = []
    for _ in range(config["pool"]):
        tiles = n * n
        sea = set(g.permutation(tiles)[: round(content["sea_share"] * tiles)].tolist())
        land = np.resize(g.permutation(len(cuts)), tiles - len(sea))  # each cut as often as the others
        g.shuffle(land)
        img = np.empty((H, W, 3), np.uint8)
        k = 0
        for i in range(tiles):
            y, x = divmod(i, n)
            if i in sea:
                tile = _sea(g, content)
            else:
                tile = cuts[land[k]]
                k += 1
                if g.integers(0, 2):
                    tile = tile[::-1]
                if g.integers(0, 2):
                    tile = tile[:, ::-1]
            img[y * t:(y + 1) * t, x * t:(x + 1) * t] = tile
        pool.append(img)
    return pool
