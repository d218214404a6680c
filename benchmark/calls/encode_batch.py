"""`nicetpu_torch.api.encode_batch` on a batch of images: photo ingest.

Inputs are the pool's images; an answer is the `.nice` bytes, right when
they equal the reference encoder's bytes of the image's RGB.  The traced
run calls `encode2.encode_batch`, which `api.encode_batch` calls once for a
batch of at most `api.MAX_BATCH` same-shape images, with `marks`.  The
least bytes of one image's work: its raw RGB read once and its `.nice`
bytes written once.
"""

from __future__ import annotations

import numpy as np

from benchmark import jobs
from benchmark.calls._images import bytes_digest, lossy, raw_bytes, rgb

SPANS = (
    ("nicetpu_torch.kernels.encode2", "encode_resident"),
    ("nicetpu_torch.kernels.encode2", "build_tables_host"),
    ("nicetpu_torch.kernels.encode2", "assemble"),
)

digest = bytes_digest


def prepare(pool, root):
    return list(pool)


class Program:
    def __init__(self, device, pool):
        from nicetpu_torch import api
        from nicetpu_torch.kernels import encode2

        self.api, self.encode2, self.device = api, encode2, device

    def call(self, inputs, stats):
        return self.api.encode_batch(inputs, device=self.device, stats=stats)

    def traced(self, inputs, stats, marks):
        if len(inputs) > self.api.MAX_BATCH or len({im.shape for im in inputs}) != 1:
            raise ValueError("the traced encode takes one batch of same-shape images")
        batch = np.stack([self.api._to_rgb(im) for im in inputs])
        return self.encode2.encode_batch(batch, device=self.device, stats=stats, marks=marks)


def work_bytes(image, data, answer) -> int:
    return raw_bytes(image) + len(answer)


def expected(pool, inputs, items, root):
    items = sorted(items)
    return dict(zip(items, map(bytes_digest, jobs.encode([rgb(pool[i]) for i in items], root))))


def control(pool, inputs, items, root):
    items = sorted(items)
    return dict(zip(items, jobs.encode([lossy(pool[i]) for i in items], root)))


def wrong(digest, expected) -> bool:
    return digest is None or digest != expected
