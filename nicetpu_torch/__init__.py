"""nicetpu_torch — the `.nice` codec's encode path in PyTorch with CUDA
kernels for the NVIDIA H100.

A port of the JAX/Pallas package `nicetpu`, which stays the reference: the
port produces the same `.nice` bytes.  It shares nicetpu's framework-neutral
modules (`format`, `spec`, `hostref`) and imports no JAX.

Public API:
    encode(img, *, device)                      -> bytes
    encode_batch(imgs, *, device, stats=None)   -> list[bytes]
"""

from nicetpu_torch.api import encode, encode_batch

__all__ = ["encode", "encode_batch"]
