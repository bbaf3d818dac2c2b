"""Share of the traced serving window with no kernel, copy or fill on the
device (percent)."""

from portbench import readers


def read(ctx):
    return readers.idle(ctx)
