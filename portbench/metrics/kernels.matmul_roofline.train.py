"""Products' share of their roofline over the training window (percent):
elk_matmul, fused_mlp and their backward kernels, the remat recompute
counted as work."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "matmul")
