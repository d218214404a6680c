"""The ordered gather of the shards' words to rank 0 and the stitch of the
payload on its host, ms a call: rank 0's stages `dist.gather_words` and
`dist.stitch`, from the program's counters of the traced window's calls.
None where the program gathers no stage times."""


def read(ctx):
    ranks, calls = ctx.stats.get("ranks"), ctx.stats.get("group_calls")
    if not ranks or not calls or "stage_ms" not in ranks[0]:
        return None
    ms = ranks[0]["stage_ms"]
    return (ms.get("gather_words", 0.0) + ms.get("stitch", 0.0)) / calls
