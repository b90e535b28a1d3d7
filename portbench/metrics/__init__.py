"""One reader a metric: `read(ctx)` returns the metric's value from a
run's `portbench.lib.cell.Context`, or None when the run has nothing to
read for it (the harness then leaves the metric out)."""
