"""Mean ms a call of the `assemble` stage: the decode core's slot assembly (`pipeline.roundtrip_batch_resident`).
A stage's time runs from the mark before it to its own (CUDA events of the
program's `marks=`), summed over the marks of its name within a call."""

STAGE = "assemble"


def read(ctx):
    if STAGE not in ctx.stage_ms or not ctx.calls:
        return None
    return ctx.stage_ms[STAGE] / ctx.calls
