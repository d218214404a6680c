"""Rasters that a host route served (the host encoder after an overflow,
or the host decoder after failed gates or a raster that does not split),
over the rasters of the window's calls, in %: the shard group's counters
"host_served" / "rasters"."""


def read(ctx):
    if "host_served" not in ctx.stats or not ctx.stats.get("rasters"):
        return None
    return 100.0 * ctx.stats["host_served"] / ctx.stats["rasters"]
