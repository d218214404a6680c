"""The port's copy of the frozen `.nice` format: constants, header layouts
and the code-length validation shared by the decoders.  Host-side numpy
only; copied from `nicetpu/format/` so that the port needs nothing of the
JAX package."""
