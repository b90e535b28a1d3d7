"""Median over the traced window's queries of `PlannedQuery.execute()`'s
wall time less the device busy time inside it: the executors' host
work and waits."""

from portbench.lib.stats import percentile


def read(ctx):
    if not ctx.exec_spans:
        return None
    ms = [((e - s) - ctx.trace.busy_in(s, e)) * 1e3
          for r, s, e in ctx.exec_spans if r.error is None]
    return percentile(ms, 50) if ms else None
