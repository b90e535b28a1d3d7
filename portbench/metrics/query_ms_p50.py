"""Median host-clock time of the window's completed queries, from the
call into `api.execute` until the rows are in host memory."""

from portbench.lib.stats import percentile


def read(ctx):
    ms = [r.ms for r in ctx.ok]
    return percentile(ms, 50) if ms else None
