"""Mean ms a call of the `host_tables` stage: the host's Huffman code lengths of the two-step encode (`encode2.encode_batch`).
A stage's time runs from the mark before it to its own (CUDA events of the
program's `marks=`), summed over the marks of its name within a call."""

STAGE = "host_tables"


def read(ctx):
    if STAGE not in ctx.stage_ms or not ctx.calls:
        return None
    return ctx.stage_ms[STAGE] / ctx.calls
