"""Device time a batch of every operation that is not one of the port's
kernels (the "torch glue" bucket: the source sample, the lane state's
launch, the normalization, the moments, copies and fills), in ms."""

from rtbench.trace import GLUE


def read(ctx):
    if ctx.batches == 0 or not ctx.device_s:
        return None
    return 1e3 * ctx.device_s.get(GLUE, 0.0) / ctx.batches
