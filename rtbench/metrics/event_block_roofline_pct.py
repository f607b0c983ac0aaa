"""The fast event block's (K1, K3, COL) share of its roofline over the traced batches."""

from rtbench.work import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "event block (K1, K2, K3, COL)")
