"""Per-layer metric readers: ``metrics/<metric>.py`` defines
``read(ctx) -> float | None`` over a :class:`port_bench.run.Traced`;
None where the run has nothing to read, and the metric is then left out
of the result line."""
