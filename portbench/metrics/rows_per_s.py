"""Fact-table rows covered by the window's completed queries, over the
window's seconds."""


def read(ctx):
    rows = sum(r.covered for r in ctx.ok)
    return rows / ctx.window_s if rows and ctx.window_s > 0 else None
