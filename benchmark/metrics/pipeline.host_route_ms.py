"""The round trip's host route, ms a profiled call: the program's spans
`pipeline.host_encode` (the host codec's encode of an image whose fused
encode overflowed) and `pipeline.host_verify` (the host decode and compare
of every image the device did not verify)."""

from benchmark import spans

NAMES = ("pipeline.host_encode", "pipeline.host_verify")


def read(ctx):
    return spans.ms_per_call(ctx, NAMES)
