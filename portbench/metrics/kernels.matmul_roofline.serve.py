"""Products' share of their roofline over the serving window (percent):
elk_matmul and fused_mlp kernels."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "matmul")
