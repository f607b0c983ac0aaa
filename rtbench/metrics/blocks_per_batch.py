"""Block launches of the trace loop a batch, from the port's launch counters."""


def read(ctx):
    if ctx.batches == 0 or ctx.launches is None:
        return None
    return ctx.launches / ctx.batches
