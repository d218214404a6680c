"""`nicetpu_torch.api.ShardGroup.roundtrip` on one raster a call: archival
of a raster too large for one card, with proof that it decodes back.

The program opens a group of RANKS ranks, one a card (NCCL on the cards,
gloo on the CPU), in set-up, and closes it when it is deleted.  Inputs are
the pool's rasters, handed to the group's rank 0 (this process), which
scatters their row blocks over the group.  An answer is (the `.nice`
bytes, the group's `verified`, the decoded raster or None).  A watched call
passes keep_decoded=True, so that the group gathers what the cards decoded
to rank 0, and its digest is (SHA-256 of the bytes, `verified`, the decoded
raster's digest).  An answer is right when its bytes equal the reference
encoder's bytes of the raster (`reference.blocked`, the reference over row
blocks, cached by pixels in `.cache/ref/` as `jobs.encode` caches), the
group's `verified` is set (the configuration is lossless, and the host
route proves its decode too) and the decoded raster equals the pool's.

The traced run calls the same entry with `marks`: every rank of the group
times its stages by CUDA events and the counters of every rank come back
in `stats`.  The program's own spans serve (SPANS is empty).  The least
bytes of one raster's work count both directions: raw RGB read and `.nice`
bytes written by the encode, `.nice` bytes read and raw RGB written by the
decode.
"""

from __future__ import annotations

import os

from benchmark import jobs
from benchmark.calls._images import bytes_digest, lossy, pixels_digest, raw_bytes, rgb
from benchmark.reference import blocked

RANKS = 4  # one a card: the cell's chips
SPANS = ()


def prepare(pool, root):
    return [rgb(im) for im in pool]


class Program:
    def __init__(self, device, pool):
        from nicetpu_torch import api

        self.group = api.ShardGroup(RANKS, device=device.type)
        self.keep = False

    def watch(self, items):
        self.keep = items is not None

    def _one(self, img, stats, marks):
        out = self.group.roundtrip(img, stats=stats, keep_decoded=self.keep, marks=marks)
        return out if self.keep else (*out, None)

    def call(self, inputs, stats):
        return [self._one(im, stats, None) for im in inputs]

    def traced(self, inputs, stats, marks):
        return [self._one(im, stats, marks) for im in inputs]

    def __del__(self):
        group = getattr(self, "group", None)
        if group is not None:
            group.close()


def work_bytes(image, data, answer) -> int:
    return 2 * (raw_bytes(image) + len(answer[0]))


def digest(answer):
    if not (isinstance(answer, tuple) and len(answer) == 3):
        return None
    data, verified, decoded = answer
    return bytes_digest(data), verified, pixels_digest(decoded)


def reference(images, root) -> list[bytes]:
    """The blocked reference's bytes of each raster, from `.cache/ref/`
    where a run has encoded the same pixels (the whole-image reference's
    cache holds the same bytes under the same name)."""
    ref = jobs._reference_sha()
    out = []
    for im in images:
        path = os.path.join(jobs.CACHE, f"{jobs._key(im, ref)}.nice")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out.append(f.read())
            continue
        data = blocked.encode(rgb(im))
        os.makedirs(jobs.CACHE, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.part"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # a concurrent reader never sees half a file
        out.append(data)
    return out


def expected(pool, inputs, items, root):
    datas = reference([pool[k] for k in items], root)
    return {k: (bytes_digest(d), pixels_digest(rgb(pool[k]))) for k, d in zip(items, datas)}


def control(pool, inputs, items, root):
    """The reference's bytes of the lossy pixels, proven by no card."""
    items = list(items)
    datas = reference([lossy(pool[k]) for k in items], root)
    return {k: (d, False, None) for k, d in zip(items, datas)}


def wrong(digest, expected) -> bool:
    if digest is None:
        return True
    data, verified, pixels = digest
    want_data, want_pixels = expected
    return data != want_data or not verified or pixels != want_pixels
