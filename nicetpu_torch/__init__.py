"""nicetpu_torch — the `.nice` lossless image codec in PyTorch with CUDA
kernels for the NVIDIA H100.

A port of the JAX/Pallas package `nicetpu`, which stays the reference: the
port produces the same `.nice` bytes and decodes them exactly.  It keeps its
own copies of the framework-neutral parts (`format`, `hostref`) and imports
nothing of `nicetpu` and no JAX.

Public API (device="cuda" unless the caller asks for "cpu"):
    encode(img, *, device)                                -> bytes
    encode_batch(imgs, *, device, stats=None)             -> list[bytes]
    decode(data, *, device)                               -> (H, W, 3) uint8
    decode_batch(datas, *, device, chunk_bits=None, stats=None)
                                                          -> list of arrays
    roundtrip_batch(imgs, *, device, stats=None)          -> (datas, verified)
"""

from nicetpu_torch.api import decode, decode_batch, encode, encode_batch, roundtrip_batch

__all__ = ["encode", "encode_batch", "decode", "decode_batch", "roundtrip_batch"]
