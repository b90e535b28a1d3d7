"""95th percentile of the same times as query_ms_p50."""

from portbench.lib.stats import percentile


def read(ctx):
    ms = [r.ms for r in ctx.ok]
    return percentile(ms, 95) if ms else None
