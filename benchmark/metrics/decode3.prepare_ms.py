"""Host preparation of a decode from bytes, ms a profiled call: the program's
spans `decode3.device_groups` (the streams split to fit the card's free
memory, the `cudaMemGetInfo` query in it) and `decode3.batch_args` (header
parse, word packing, uploads, the tables launch)."""

from benchmark import spans

NAMES = ("decode3.device_groups", "decode3.batch_args")


def read(ctx):
    return spans.ms_per_call(ctx, NAMES)
