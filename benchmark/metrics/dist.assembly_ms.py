"""The sharded decode's slot assembly (its own carried torch scans), ms a
call: the longest `dist.assembly` of any rank, since the records'
all-gather after it waits for the slowest, from the counters every rank
sends back in the traced window's calls.  None where the program gathers
no stage times."""


def read(ctx):
    ranks, calls = ctx.stats.get("ranks"), ctx.stats.get("group_calls")
    if not ranks or not calls or any("stage_ms" not in r for r in ranks):
        return None
    return max(r["stage_ms"].get("assembly", 0.0) for r in ranks) / calls
