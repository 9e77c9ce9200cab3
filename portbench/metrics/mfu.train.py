"""mfu.train: the detector's model FLOPs trained a second in the window
over the float32-exact tensor-core peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train_clips_per_s")
