"""Raw RGB8 megabytes (10^6 bytes, H x W x 3) of the images the window's
calls returned, over the window's seconds: all the work over all the time,
from the first call's start to the last call's return."""


def read(ctx):
    done = sum(r.raw_bytes for r in ctx.records if r.error is None)
    return done / 1e6 / (ctx.t1 - ctx.t0)
