"""The reconstruction's serial carry pipeline, ms a call: the longest
`dist.carry_wait` of any rank (rank d waits there for the four rows that
rank d - 1 reconstructs last), from the counters every rank sends back in
the traced window's calls.  None where the program gathers no stage
times."""


def read(ctx):
    ranks, calls = ctx.stats.get("ranks"), ctx.stats.get("group_calls")
    if not ranks or not calls or any("stage_ms" not in r for r in ranks):
        return None
    return max(r["stage_ms"].get("carry_wait", 0.0) for r in ranks) / calls
