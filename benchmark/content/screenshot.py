"""Screenshot-style RGBA rasters drawn from the seed, after the QOI
benchmark suite's `screenshot_web` category: a web page with a header bar,
a side menu, a grid of photos from the corpus, an article, and cards with
title bars, text and linear gradients.

Every seed draws the same elements at the same sizes, and the same photo
crops (each source's centre); the seed draws which column holds the
photos, the photos' order and flips, the colours, the cards' order, the
gradients, the glyph shapes and the words.  Nothing is resampled.  Text is rows of glyphs made of 1-2 px strokes, a 2 px stroke's
second column at half weight as anti-aliasing.  Alpha is the content's
"alpha" value throughout.

content keys: "photo_sources" (four corpus names, at least "photo_tile"
on each side), "photo_tile", "header_px", "sidebar_px", "margin_px",
"card_heights" (three, in pixels, drawn in a seeded order), "gradient_px"
(a card's gradient height), "glyph" ({"width", "height", "line_px",
"atlas"}), "alpha".
"""

from __future__ import annotations

import numpy as np

from benchmark.seeds import rng


def corpus_names(content: dict) -> list[str]:
    return list(content["photo_sources"])


def _light(g) -> np.ndarray:
    return g.integers(228, 256, 3)


def _dark(g) -> np.ndarray:
    return g.integers(16, 90, 3)


def _atlas(g, glyph: dict) -> np.ndarray:
    """(atlas + 1, height, width) float weights; the last glyph is a space."""
    gh, gw, n = glyph["height"], glyph["width"], glyph["atlas"]  # at least 12 x 6
    out = np.zeros((n + 1, gh, gw), np.float32)
    for k in range(n):
        for _ in range(int(g.integers(2, 5))):
            thick = int(g.integers(1, 3))
            if g.integers(0, 2):  # vertical stroke
                x = int(g.integers(1, gw - 2))
                y0 = int(g.integers(2, 8))
                y1 = int(g.integers(y0 + 3, gh - 2))
                out[k, y0:y1, x] = 1.0
                if thick == 2:
                    out[k, y0:y1, x + 1] = np.maximum(out[k, y0:y1, x + 1], 0.5)
            else:  # horizontal stroke
                y = int(g.integers(2, gh - 3))
                x0 = int(g.integers(1, gw - 4))
                x1 = int(g.integers(x0 + 2, gw - 1))
                out[k, y, x0:x1] = 1.0
                if thick == 2:
                    out[k, y + 1, x0:x1] = np.maximum(out[k, y + 1, x0:x1], 0.5)
    return out


def _text(img, g, atlas, glyph, box, fg, bg) -> None:
    """Fill box (y, x, h, w) of a flat `bg` area with ragged lines of words."""
    y, x, h, w = box
    gh, gw, lp = glyph["height"], glyph["width"], glyph["line_px"]
    lines, cols = min(h, img.shape[0] - y) // lp, min(w, img.shape[1] - x) // gw
    if lines <= 0 or cols <= 0:
        return
    space = atlas.shape[0] - 1
    ids = g.integers(0, space, (lines, cols))
    # words of 2-9 glyphs, one space after each; lines end at 55-100 % of the box
    gaps = np.cumsum(g.integers(3, 11, (lines, cols // 3 + 1)), axis=1) - 1
    rows = np.broadcast_to(np.arange(lines)[:, None], gaps.shape)
    inside = gaps < cols
    ids[rows[inside], gaps[inside]] = space
    ends = (cols * g.uniform(0.55, 1.0, lines)).astype(int)
    ids[np.arange(cols)[None, :] >= ends[:, None]] = space
    weight = np.zeros((lines, lp, cols, gw), np.float32)
    weight[:, :gh] = atlas[ids].transpose(0, 2, 1, 3)
    a = weight.reshape(lines * lp, cols * gw)[..., None]
    region = np.rint(bg * (1 - a) + fg * a).astype(np.uint8)
    img[y:y + lines * lp, x:x + cols * gw, :3] = region


def _gradient(img, g, box) -> None:
    y, x, h, w = box
    c0, c1 = g.integers(0, 256, 3), g.integers(0, 256, 3)
    kind = int(g.integers(0, 3))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = (xx / max(w - 1, 1), yy / max(h - 1, 1), (xx + yy) / max(w + h - 2, 1))[kind][..., None]
    img[y:y + h, x:x + w, :3] = np.rint(c0 * (1 - t) + c1 * t).astype(np.uint8)


def _photos(img, g, corpus, content, y, x) -> None:
    tile = content["photo_tile"]
    names = [content["photo_sources"][i] for i in g.permutation(len(content["photo_sources"]))]
    for k, name in enumerate(names[:4]):
        src = corpus[name]
        oy, ox = (src.shape[0] - tile) // 2, (src.shape[1] - tile) // 2
        crop = src[oy:oy + tile, ox:ox + tile]
        if g.integers(0, 2):
            crop = crop[::-1]
        if g.integers(0, 2):
            crop = crop[:, ::-1]
        ty, tx = y + (k // 2) * tile, x + (k % 2) * tile
        img[ty:ty + tile, tx:tx + tile, :3] = crop


def draw(config: dict, g, corpus: dict) -> np.ndarray:
    c = config["content"]
    H, W = config["shape"]["height"], config["shape"]["width"]
    glyph, m = c["glyph"], c["margin_px"]
    atlas = _atlas(g, glyph)
    img = np.empty((H, W, 4), np.uint8)
    img[..., 3] = c["alpha"]
    page = _light(g)
    img[..., :3] = page

    # header bar: a title line and a row of tabs
    hdr, dark = c["header_px"], _dark(g)
    img[:hdr, :, :3] = dark
    _text(img, g, atlas, glyph, (hdr // 2 - glyph["line_px"] // 2, m, glyph["line_px"], W // 3), _light(g), dark)
    tab = np.minimum(dark + 40, 255)
    for k in range(6):
        tx = W - m - (k + 1) * (W // 17)
        img[hdr // 2 - hdr // 6:hdr // 2 + hdr // 6, tx:tx + W // 20, :3] = tab

    # side menu
    side = c["sidebar_px"]
    menu = g.integers(196, 240, 3)
    img[hdr:, :side, :3] = menu
    _text(img, g, atlas, glyph, (hdr + m // 2, m // 2, H - hdr - m, side - m), _dark(g), menu)

    # content: the photo grid and the article in one column, cards in the other
    x0, x1 = side + m, W - m
    photo_w = 2 * c["photo_tile"]
    card_w = x1 - x0 - photo_w - m
    photo_left = bool(g.integers(0, 2))
    px = x0 if photo_left else x1 - photo_w
    cx = x0 + photo_w + m if photo_left else x0
    top = hdr + m
    _photos(img, g, corpus, c, top, px)
    _text(img, g, atlas, glyph, (top + photo_w + m, px, H - m - (top + photo_w + m), photo_w), _dark(g), page)

    y, pad = top, m // 2
    for h in (c["card_heights"][i] for i in g.permutation(len(c["card_heights"]))):
        border, title, body = g.integers(120, 180, 3), g.integers(150, 230, 3), _light(g)
        img[y:y + h, cx:cx + card_w, :3] = border
        img[y + 1:y + h - 1, cx + 1:cx + card_w - 1, :3] = body
        tb = glyph["line_px"] + 16
        img[y + 1:y + 1 + tb, cx + 1:cx + card_w - 1, :3] = title
        _text(img, g, atlas, glyph, (y + 9, cx + pad // 2, glyph["line_px"], card_w - pad), _dark(g), title)
        gy = y + 1 + tb + pad
        _gradient(img, g, (gy, cx + pad, c["gradient_px"], card_w - 2 * pad))
        ty = gy + c["gradient_px"] + pad
        _text(img, g, atlas, glyph, (ty, cx + pad, y + h - pad - ty, card_w - 2 * pad), _dark(g), body)
        y += h + m
    return img


def make(config: dict, seed: int, corpus: dict) -> list[np.ndarray]:
    g = rng(seed, "screenshot")
    return [draw(config, g, corpus) for _ in range(config["pool"])]
