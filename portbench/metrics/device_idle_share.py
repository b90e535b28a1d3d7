"""The share of the traced window in which no operation ran on the
device, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.trace.window[1] - ctx.trace.window[0]
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 else None
