"""Process start to the first timed query: generation, load, device
initialisation, column statistics, the cold query and the warm-up."""


def read(ctx):
    return ctx.setup_s
