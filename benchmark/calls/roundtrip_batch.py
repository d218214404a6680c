"""`nicetpu_torch.api.roundtrip_batch` on a batch of images: archival with
proof of losslessness.

Inputs are the pool's images.  An answer is (the `.nice` bytes, the
program's `verified` flag, what the device decoded), one an image.  The
device's pixels are read where the program compares them: every rung that
tries to verify a batch hands its decoded (B, 3, N) planes to
`decode3._equal_planar`, which this module wraps.  In a watched call the
wrapper compares each image's planes with the benchmark's own copy of the
pool's RGB on the device (uploaded at set-up, `resident_bytes`), so what
the device decoded is judged without a sync and without keeping the planes.
An answer is right when its bytes equal the reference encoder's bytes of
the image's RGB and, where the program says the device verified the image,
some rung decoded that image's pixels exactly.  An image the program leaves
unverified is proven by its host route and judged by its bytes.  A watched
call is one batch: at most `api.MAX_BATCH` same-shape images.

The traced run calls `pipeline.roundtrip_batch_resident` on the uploaded
batch, as `api.roundtrip_batch` does, with `marks`.  The least bytes of one
image's work count both directions: raw RGB read and `.nice` bytes written
by the encode, `.nice` bytes read and raw RGB written by the decode.
"""

from __future__ import annotations

from benchmark.calls import encode_batch
from benchmark.calls._images import bytes_digest, lossy, raw_bytes, rgb

SPANS = (
    ("nicetpu_torch.pipeline", "upload_batch"),
    ("nicetpu_torch.kernels.decode3", "roundtrip_verify_fused"),
    ("nicetpu_torch.kernels.decode3", "verify_words_device"),
    ("nicetpu_torch.pipeline", "_assemble_payloads"),
    ("nicetpu_torch.hostref.oracle", "encode_native"),
    ("nicetpu_torch.hostref.oracle", "decode_native"),
)

CHUNK = 1 << 20  # pixels compared at once: 3 MB of temporaries on the device

prepare = encode_batch.prepare
expected = encode_batch.expected


def _watcher(decode3) -> list:
    """Wrap `decode3._equal_planar` once a process, and return its slot for
    the Program whose call is watched: the program's result is returned
    unchanged, and the watching Program sees the decoded planes."""
    fn = decode3._equal_planar
    if hasattr(fn, "benchmark_watcher"):
        return fn.benchmark_watcher
    slot: list = [None]

    def _equal_planar(out, flat):
        eq = fn(out, flat)
        if slot[0] is not None:
            slot[0].capture(out)
        return eq

    _equal_planar.benchmark_watcher = slot
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
        self.resident_bytes = torch.cuda.memory_allocated(device) - before if cuda else 0
        self.items, self.captured = None, []

    def watch(self, items):
        self.items = None if items is None else list(items)
        self.captured = []
        self.slot[0] = self if items is not None else None

    def capture(self, out):
        """(B,) bool on the device: image b's planes equal the pool image."""
        torch, items = self.torch, self.items
        if out.dim() != 3 or out.shape[0] != len(items) or out.shape[1] != 3:
            self.captured.append(torch.zeros(len(items), dtype=torch.bool, device=out.device))
            return
        flags = []
        for b, k in enumerate(items):
            ref = self.refs[k]
            n = ref.shape[1]
            if out.shape[2] != n:
                flags.append(torch.zeros((), dtype=torch.bool, device=out.device))
                continue
            parts = [(out[b, :, s:s + CHUNK] == ref[:, s:s + CHUNK]).all() for s in range(0, n, CHUNK)]
            flags.append(torch.stack(parts).all())
        self.captured.append(torch.stack(flags))

    def answers(self, datas, verified):
        if len(verified) != len(datas):
            raise RuntimeError("the round trip returned a proof for another number of images")
        if self.items is None:
            seen = [None] * len(datas)
        elif self.captured and len(datas) == len(self.items):
            seen = self.torch.stack(self.captured).any(0).cpu().tolist()
        else:
            seen = [False] * len(datas)
        return [(d, bool(v), s) for d, v, s in zip(datas, verified, seen)]

    def call(self, inputs, stats):
        return self.answers(*self.api.roundtrip_batch(inputs, device=self.device, stats=stats))

    def traced(self, inputs, stats, marks):
        if len(inputs) > self.api.MAX_BATCH or len({im.shape for im in inputs}) != 1:
            raise ValueError("the traced round trip takes one batch of same-shape images")
        batch = [self.api._to_rgb(im) for im in inputs]
        for k in ("retries", "fallbacks", "overflow_fallbacks"):
            stats.setdefault(k, 0)
        return self.answers(*self.pipeline.roundtrip_batch_resident(
            self.pipeline.upload_batch(batch, self.device), batch, stats=stats, marks=marks))


def work_bytes(image, data, answer) -> int:
    return 2 * (raw_bytes(image) + len(answer[0]))


def digest(answer):
    if not (isinstance(answer, tuple) and len(answer) == 3):
        return None
    data, verified, seen = answer
    return bytes_digest(data), verified, seen


def control(pool, inputs, items, root):
    """The reference's bytes of the lossy pixels, proven by no device."""
    return {k: (data, False, None) for k, data in encode_batch.control(pool, inputs, items, root).items()}


def wrong(digest, expected) -> bool:
    if digest is None:
        return True
    data, verified, seen = digest
    return data != expected or (verified and seen is not True)
