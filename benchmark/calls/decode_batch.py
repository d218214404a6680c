"""`nicetpu_torch.api.decode_batch` on the reference's `.nice` bytes of a
batch: image serving reads stored files.

Inputs are the reference encoder's bytes of each pool image, made before
the window (cached by `jobs.encode`); an answer is the decoded (H, W, 3)
uint8 array, right when it equals the image's RGB.  The least bytes of one
image's work: its `.nice` bytes read once and its raw RGB written once.
"""

from __future__ import annotations

from benchmark import jobs
from benchmark.calls._images import lossy, pixels_digest, raw_bytes, rgb

SPANS = (
    ("nicetpu_torch.kernels.decode3", "device_groups"),
    ("nicetpu_torch.kernels.decode3", "_batch_args"),
    ("nicetpu_torch.kernels.decode3", "_decode_core_v3"),
    ("nicetpu_torch.hostref.oracle", "decode_native"),
)

digest = pixels_digest


def prepare(pool, root):
    return jobs.encode(pool, root)


class Program:
    def __init__(self, device, pool):
        from nicetpu_torch import api

        self.api, self.device = api, device

    def call(self, inputs, stats):
        return self.api.decode_batch(inputs, device=self.device, stats=stats)

    def traced(self, inputs, stats, marks):
        return self.call(inputs, stats)


def work_bytes(image, data, answer) -> int:
    return len(data) + raw_bytes(image)


def expected(pool, inputs, items, root):
    return {i: pixels_digest(rgb(pool[i])) for i in items}


def control(pool, inputs, items, root):
    return {i: lossy(pool[i]) for i in items}


def wrong(digest, expected) -> bool:
    return digest is None or digest != expected
