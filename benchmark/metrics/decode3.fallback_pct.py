"""Images that the device path did not serve, over the images of the
window's calls, in %: the program's `stats`, ("fallbacks" +
"overflow_fallbacks") / images.  A decode's fallbacks are the streams
the host decoded; a round trip's, the images proven on the host and those
the host encoded."""


def read(ctx):
    if "fallbacks" not in ctx.stats or not ctx.images:
        return None
    served = ctx.stats["fallbacks"] + ctx.stats.get("overflow_fallbacks", 0)
    return 100.0 * served / ctx.images
