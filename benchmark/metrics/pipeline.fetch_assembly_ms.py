"""Mean ms a call of the `fetch+assembly` stage: the payload's fetch and the `.nice` byte assembly on the host (`encode2.encode_batch`, `pipeline.roundtrip_batch_resident`).
A stage's time runs from the mark before it to its own (CUDA events of the
program's `marks=`), summed over the marks of its name within a call."""

STAGE = "fetch+assembly"


def read(ctx):
    if STAGE not in ctx.stage_ms or not ctx.calls:
        return None
    return ctx.stage_ms[STAGE] / ctx.calls
