"""One raster encoded and decoded across `torch.distributed` ranks.

Counterpart of `nicetpu/dist/`: `sharded` (encode), `sharded_decode`
(single-raster and batch decode), `multihost` (rank-0 results,
`initialize_distributed`), `comm` (the collectives) and `launch` (n local
ranks, `dryrun_multichip`).
"""
