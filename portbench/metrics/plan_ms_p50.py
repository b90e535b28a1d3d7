"""Median host time of parse, bind, cost and plan (`parser.parse` and
`plan_query`), timed by the harness in the traced run."""

from portbench.lib.stats import percentile


def read(ctx):
    ms = [r.plan_ms for r in ctx.ok if r.plan_ms is not None]
    return percentile(ms, 50) if ms else None
