"""input_ms_per_step.corr: device ms under the program's ``eeg.step.input``
span (the cached rows' gather, standardize, and each clip's graph and
supports) per step."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, spans.INPUT)
