"""nicetpu_torch — the `.nice` lossless image codec in PyTorch with CUDA
kernels for the NVIDIA H100.

A port of the JAX/Pallas package `nicetpu`, which stays the reference: the
port produces the same `.nice` bytes and decodes them exactly.  It keeps its
own copies of the framework-neutral parts (`format`, `hostref`) and imports
nothing of `nicetpu` and no JAX.

Public API (on the card unless the caller asks for device="cpu" or, through
a `RuntimeConfig`, for the "cpu", "native" or "spec" backend):
    encode(img, *, device=None, config=None, alpha="drop") -> bytes
    encode_batch(imgs, *, device, config, stats=None)     -> list[bytes]
    decode(data, *, device=None, config=None)             -> (H, W, 3) uint8
    decode_batch(datas, *, device, config, chunk_bits=None, stats=None)
                                                          -> list of arrays
    roundtrip_batch(imgs, *, device, stats=None)          -> (datas, verified)
    imread(path) / imwrite(path, img)                     PNG <-> array
    RuntimeConfig                                         backend, batch, workers
Beside it: `pipeline.roundtrip_hybrid` and `pipeline.Pipeline` (the
schedulers), `corpus.encode_corpus` (a streamed corpus with a manifest) and
`python -m nicetpu_torch.cli <from> <to>` (PNG <-> `.nice`).
"""

from nicetpu_torch.api import (
    decode,
    decode_batch,
    encode,
    encode_batch,
    imread,
    imwrite,
    roundtrip_batch,
)
from nicetpu_torch.config import RuntimeConfig

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "encode_batch",
    "decode_batch",
    "roundtrip_batch",
    "imread",
    "imwrite",
    "RuntimeConfig",
    "__version__",
]
