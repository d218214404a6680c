"""The largest peak of device memory of any rank's card, in GiB: each
rank's `torch.cuda.max_memory_allocated`, which the group gathers into
stats["ranks"] (0 on the CPU).  `peak_device_GiB` reads card 0 alone.
None where the program gathers no counters of its ranks."""


def read(ctx):
    ranks = ctx.stats.get("ranks")
    if not ranks or any("peak_device_bytes" not in r for r in ranks):
        return None
    return max(r["peak_device_bytes"] for r in ranks) / 2**30
