"""Median of the traced batches' times (CUDA events at each batch's end)."""

import statistics


def read(ctx):
    return statistics.median(ctx.batch_ms) if ctx.batch_ms else None
