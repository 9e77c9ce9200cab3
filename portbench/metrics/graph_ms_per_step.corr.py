"""graph_ms_per_step.corr: device ms under the program's ``eeg.step.graph``
span (each clip's correlation Gram, its top-k and the dual random walk)
per step."""

from portbench import spans

GRAPH = "eeg.step.graph"


def read(ctx):
    return spans.device_ms_per_step(ctx, GRAPH)
