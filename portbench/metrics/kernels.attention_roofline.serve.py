"""Attention's share of its roofline over the serving window (percent):
flash attention over prefill chunks and decode attention over the live
positions."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "attention")
