"""The reconstruction's chains (one an image and channel, on every rank)
that ran on a thread-block cluster, in %: 100 x the sum over the ranks of
the counter "recon_cluster_chains" over that of "recon_chains", from the
counters every rank sends back in the traced window's calls.  None where
the program counts no chains, and on the CPU, where no chain runs a
kernel."""


def read(ctx):
    ranks = ctx.stats.get("ranks")
    if ctx.device.type != "cuda" or not ranks or any("recon_chains" not in r for r in ranks):
        return None
    chains = sum(r["recon_chains"] for r in ranks)
    if not chains:
        return None
    return 100.0 * sum(r.get("recon_cluster_chains", 0) for r in ranks) / chains
