"""Mean device time of value_and_grad a step: CUDA events around the call
(ms)."""

from portbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "value_and_grad")
