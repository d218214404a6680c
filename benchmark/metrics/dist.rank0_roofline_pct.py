"""Card 0's share of the profiled calls' least time, over its busy time, in
%: the least bytes of the work (the call module's `work_bytes`, from the
rasters and the `.nice` bytes) divided by the group's ranks, one a card,
over the card's published memory bandwidth (`peaks.json`), over card 0's
busy time in the trace.  `kernels.roofline_pct` would credit card 0 with
every card's work.  None without a device trace or a group."""


def read(ctx):
    t, ranks = ctx.trace, ctx.stats.get("ranks")
    card = ctx.peaks.get("cards", {}).get(ctx.card)
    if t is None or not t.device_ops or t.busy_s <= 0 or card is None or not ranks:
        return None
    return 100.0 * t.work_bytes / len(ranks) / card["hbm_bytes_per_s"] / t.busy_s
