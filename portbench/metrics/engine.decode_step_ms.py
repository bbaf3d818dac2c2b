"""Mean device time of ServeEngine.step over the window: CUDA events around
each call, its launches included (ms)."""

from portbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "step")
