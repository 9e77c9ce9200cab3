"""input_ms_per_step.train: device ms under the program's ``eeg.step.input``
span (the cached rows' gather and the pipeline's standardize and
supports) per step."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.INPUT)
