"""The run's first query, inside set-up: the column statistics it needs
and its execution (first upload of the planes, hash builds, plans)."""


def read(ctx):
    return ctx.cold_query_ms
