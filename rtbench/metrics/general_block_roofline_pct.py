"""The general block with detectors' (G+E) share of its roofline over the traced batches."""

from rtbench.work import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "G+E (general block, detectors)")
