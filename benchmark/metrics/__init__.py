"""One reader a metric, `<name>.py`, found by the metric's name in
`BENCHMARK.json`.  Each has `read(ctx) -> float | None` over the run's
`benchmark.run.Ctx`; None where it finds nothing to read, and the harness
then leaves the metric out of the line."""
