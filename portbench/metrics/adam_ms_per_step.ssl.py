"""adam_ms_per_step.ssl: device ms under torch.optim.Adam's step record
(the L2 term and Adam) per step."""

from portbench import readers


def read(ctx):
    return readers.adam_ms_per_step(ctx)
