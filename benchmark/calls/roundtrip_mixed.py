"""`nicetpu_torch.api.roundtrip_batch` on a whole upload set of images of
mixed sizes in one call: photo-archive ingest with proof of losslessness.

Inputs are the pool's images; an answer is (the `.nice` bytes, the
program's `verified` flag, whether the device decoded the image), one an
image, as `roundtrip_batch`'s.  The program cuts the call into device
batches as it sees fit: batches of one shape, or of several shapes padded
to the largest.  So the rows of a batch are matched with the watched
images by content, not by position: every rung that tries to verify a
batch hands its decoded (B, 3, N) planes and the (B, N, 3) batch it
uploaded to `decode3._equal_planar`, which this module wraps once a
process.  A row of the upload whose first PREFIX pixels are a watched
image's holds that image (one device compare of every row with every
watched image's first pixels, one read of the matches); the image counts
as decoded where the decoded planes of that row begin with its pixels,
compared whole against the benchmark's own copy of the pool's RGB on the
device (`resident_bytes`).  An answer is right when its bytes equal the
reference encoder's bytes of the image's RGB and, where the program says
the device verified the image, some rung decoded its pixels exactly in the
row that held it.

The traced run is the call itself, all its batches, with the stage marks
of each batch's round trip (`api.roundtrip_batch(marks=)`; a program whose
`roundtrip_batch` takes no marks gets them through each
`pipeline.roundtrip_batch_resident` call).  The least bytes of an image's
work are counted as `roundtrip_batch` counts them.
"""

from __future__ import annotations

import functools
import inspect

from benchmark.calls import encode_batch, roundtrip_batch
from benchmark.calls._images import raw_bytes, rgb  # noqa: F401  (raw_bytes: the harness's)

SPANS = roundtrip_batch.SPANS + (("nicetpu_torch.api", "plan_batches"),)
PREFIX = 64  # first pixels of a row that pick the images it may hold
CHUNK = roundtrip_batch.CHUNK

prepare = encode_batch.prepare
expected = encode_batch.expected
work_bytes = roundtrip_batch.work_bytes
digest = roundtrip_batch.digest
control = roundtrip_batch.control
wrong = roundtrip_batch.wrong


def _watcher(decode3) -> list:
    """Wrap `decode3._equal_planar` once a process, and return its slot for
    the Program whose call is watched: the program's result is returned
    unchanged, and the watching Program sees the decoded planes and the
    upload."""
    fn = decode3._equal_planar
    if hasattr(fn, "mixed_watcher"):
        return fn.mixed_watcher
    slot: list = [None]

    def _equal_planar(out, flat):
        eq = fn(out, flat)
        if slot[0] is not None:
            slot[0].capture(out, flat)
        return eq

    _equal_planar.mixed_watcher = slot
    decode3._equal_planar = _equal_planar
    return slot


class Program:
    def __init__(self, device, pool):
        import torch
        from nicetpu_torch import api, pipeline
        from nicetpu_torch.kernels import decode3

        self.api, self.pipeline, self.device, self.torch = api, pipeline, device, torch
        self.slot = _watcher(decode3)
        cuda = device.type == "cuda"
        before = torch.cuda.memory_allocated(device) if cuda else 0
        self.refs = [torch.from_numpy(rgb(im).reshape(-1, 3).T.copy()).to(device) for im in pool]
        self.prefix = min(PREFIX, min(r.shape[1] for r in self.refs))
        self.heads = torch.stack([r[:, : self.prefix] for r in self.refs])  # (pool, 3, prefix)
        self.resident_bytes = torch.cuda.memory_allocated(device) - before if cuda else 0
        self.items, self.found = None, []

    def watch(self, items):
        self.items = None if items is None else list(items)
        self.found = []
        self.slot[0] = self if items is not None else None

    def capture(self, out, flat):
        """Match the rows of a rung's upload (B, N, 3) with the watched
        images; keep, for each match, a device flag: the decoded (B, 3, N)
        planes of the row begin with image k's pixels."""
        torch, items = self.torch, self.items
        if (out.dim() != 3 or out.shape[1] != 3 or flat.dim() != 3
                or tuple(flat.shape[:2]) != (out.shape[0], out.shape[2]) or out.shape[2] < self.prefix):
            return
        rows = flat[:, : self.prefix].transpose(1, 2)  # (B, 3, prefix)
        hits = (rows[:, None] == self.heads[items][None]).flatten(2).all(2)  # (B, K)
        for b, j in hits.nonzero().tolist():
            ref = self.refs[items[j]]
            n = ref.shape[1]
            if n > out.shape[2]:
                continue
            parts = [(out[b, :, s : min(s + CHUNK, n)] == ref[:, s : s + CHUNK]).all() for s in range(0, n, CHUNK)]
            self.found.append((j, torch.stack(parts).all()))

    def answers(self, datas, verified):
        if len(verified) != len(datas):
            raise RuntimeError("the round trip returned a proof for another number of images")
        if self.items is None:
            seen = [None] * len(datas)
        elif len(datas) != len(self.items):
            seen = [False] * len(datas)
        else:
            seen = [False] * len(datas)
            if self.found:
                flags = self.torch.stack([f for _, f in self.found]).cpu().tolist()
                for (j, _), ok in zip(self.found, flags):
                    seen[j] = seen[j] or ok
        return [(d, bool(v), s) for d, v, s in zip(datas, verified, seen)]

    def call(self, inputs, stats):
        return self.answers(*self.api.roundtrip_batch(inputs, device=self.device, stats=stats))

    def traced(self, inputs, stats, marks):
        if "marks" in inspect.signature(self.api.roundtrip_batch).parameters:
            return self.answers(*self.api.roundtrip_batch(inputs, device=self.device, stats=stats, marks=marks))
        resident = self.pipeline.roundtrip_batch_resident
        self.pipeline.roundtrip_batch_resident = functools.partial(resident, marks=marks)
        try:
            return self.call(inputs, stats)
        finally:
            self.pipeline.roundtrip_batch_resident = resident
