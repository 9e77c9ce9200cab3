"""mfu.corr: the Corr-DCRNN's model FLOPs (M=5) trained a second in the
window over the float32-exact tensor-core peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train_clips_per_s")
