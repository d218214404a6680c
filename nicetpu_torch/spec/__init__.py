"""The port's copy of `nicetpu.spec`, the numpy reference codec.

The readable host-side ground truth of the `.nice` format: a vectorized
numpy tokenizer implementing the math of the device kernels and a serial
decoder loop.  It needs no compiler (the `native` host codec builds its C++
library with g++ at first use), and `api` serves it when the caller asks
for the "spec" backend by name.
"""
