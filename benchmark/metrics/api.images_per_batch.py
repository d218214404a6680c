"""Images a device batch of the round trip, over the window's calls: the
images of the calls over the program's `stats["device_batches"]`, which
`api.roundtrip_batch` counts.  None where the program counts no batches."""


def read(ctx):
    batches = ctx.stats.get("device_batches")
    if not batches or not ctx.images:
        return None
    return ctx.images / batches
