"""launches_per_step.corr: kernels a traced optimizer step (a count)."""

from portbench import readers


def read(ctx):
    return readers.launches_per_step(ctx)
