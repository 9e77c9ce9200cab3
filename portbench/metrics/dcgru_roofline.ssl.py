"""dcgru_roofline.ssl: the least time of the traced steps' DCGRU work over
the device time of the hand-written kernels."""

from portbench import readers


def read(ctx):
    return readers.dcgru_roofline_train(ctx)
