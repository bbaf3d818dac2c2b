"""The serving window's model FLOPs over its seconds at the bf16 peak
(percent)."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
