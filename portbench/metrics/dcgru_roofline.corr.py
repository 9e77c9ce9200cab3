"""dcgru_roofline.corr: the least time of the traced steps' DCGRU work
(per-clip operators, M=5) over the device time of the hand-written
kernels."""

from portbench import readers


def read(ctx):
    return readers.dcgru_roofline_train(ctx)
