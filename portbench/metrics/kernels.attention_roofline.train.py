"""Attention's share of its roofline over the training window (percent):
windowed flash attention forward (twice under remat) and backward."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "attention")
