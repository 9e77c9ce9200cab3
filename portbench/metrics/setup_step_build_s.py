"""setup_step_build_s: host seconds of the program's ``TrainStep``
build (its ``eeg.setup.train_step`` total, the optimizer's inside it)."""

from portbench import spans


def read(ctx):
    return spans.setup_seconds(spans.STEP_BUILD)
