"""mfu.ssl: the SSL model's FLOPs trained a second in the window (pairs)
over the float32-exact tensor-core peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train_pairs_per_s")
