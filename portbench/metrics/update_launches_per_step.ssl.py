"""update_launches_per_step.ssl: kernels launched under the program's
``eeg.step.update`` span (the clip, the L2 term, Adam) per step."""

from portbench import spans


def read(ctx):
    return spans.launches_per_step(ctx, spans.UPDATE)
