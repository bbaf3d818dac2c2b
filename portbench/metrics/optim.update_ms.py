"""Mean device time of the AdamW update a step: CUDA events around
apply_update (ms)."""

from portbench import readers


def read(ctx):
    return readers.mean_ms(ctx, "apply_update")
