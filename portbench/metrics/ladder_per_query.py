"""Retry-ladder rungs a query: the perfmon counters salt_retries,
sort_fallbacks, dense_fallbacks, regrow_retries, fanout_retries and
recheck_chunks, summed over one round of the cell's templates run with
perfmon on after the traced window, over the queries of that round."""


def read(ctx):
    if not ctx.ladder or not ctx.ladder["queries"]:
        return None
    return sum(ctx.ladder["counts"].values()) / ctx.ladder["queries"]
