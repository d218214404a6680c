"""The shard group's collectives on rank 0, ms a call: rank 0's stages that
move data between the ranks (`dist.<stage>`: the scatter of the row blocks,
without rank 0's upload of the raster, the halo, the first changes'
all-gather, the summed histogram, the ordered gather of the words, the
bytes' broadcast and the records' all-gather), from the program's counters
of the traced window's calls (CUDA events where the call took marks, the
host clock on the CPU).  Each holds rank 0's wait for the slowest rank to
reach it.  The carry's wait and the verdict's all-reduce, which wait for
the serial carry pipeline, are left to `dist.carry_ms`.  None where the
program gathers no stage times."""

STAGES = ("scatter", "halo", "first_changes", "histogram_psum", "gather_words", "bytes_broadcast",
          "records_all_gather")


def read(ctx):
    ranks, calls = ctx.stats.get("ranks"), ctx.stats.get("group_calls")
    if not ranks or not calls or "stage_ms" not in ranks[0]:
        return None
    return sum(ranks[0]["stage_ms"].get(s, 0.0) for s in STAGES) / calls
