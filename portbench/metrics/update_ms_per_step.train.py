"""update_ms_per_step.train: device ms under the program's
``eeg.step.update`` span (the clip, the L2 term, Adam) per step."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.UPDATE)
