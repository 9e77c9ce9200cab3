"""graph_clips_per_step.corr: clips whose correlation graph the program
built per traced step: its ``eeg.step.graph_clips`` count, which ticks
only while a profiler runs, over the steps of both traced parts."""

GRAPH_CLIPS = "eeg.step.graph_clips"


def read(ctx):
    try:
        from eeg_gnn_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    total = totals().get(GRAPH_CLIPS)
    steps = ctx["info"].get("steps", 0) + ctx["detail_info"].get("steps", 0)
    if total is None or not steps:
        return None
    return total.count / steps
