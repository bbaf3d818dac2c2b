"""The training window's model FLOPs (6 x parameters x tokens plus
attention forward and backward, no recompute) over its seconds at the
bf16 peak (percent)."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
