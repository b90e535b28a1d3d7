"""The device's share of its bandwidth roofline over the traced window's
queries, in %: each query's logical bytes (every column it reads at its
value width, read once, and its result rows, written once) over the
HBM bandwidth, summed, over the device busy time inside the queries'
executions, summed.  Queries with no device time are left out."""

from portbench.lib.stats import HBM_BYTES_PER_S


def read(ctx):
    if not ctx.exec_spans:
        return None
    bound = busy = 0.0
    for r, s, e in ctx.exec_spans:
        b = ctx.trace.busy_in(s, e)
        if r.error is None and b > 0:
            bound += r.logical_bytes / HBM_BYTES_PER_S
            busy += b
    return 100.0 * bound / busy if busy > 0 else None
