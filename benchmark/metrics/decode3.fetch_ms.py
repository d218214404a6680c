"""The decode's host bytes, ms a profiled call: the program's spans
`decode3.fetch` (each rung's pixels and gates copied to the host after the
first copy has waited for the core, and their concatenation),
`decode3.ladder_merge` (the retry ladder's copies of them) and
`decode3.to_arrays` (the (H, W, 3) arrays handed back)."""

from benchmark import spans

NAMES = ("decode3.fetch", "decode3.ladder_merge", "decode3.to_arrays")


def read(ctx):
    return spans.ms_per_call(ctx, NAMES)
