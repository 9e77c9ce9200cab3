"""The fault of a per-clip graph, planted under the timed path: every clip
of a batch gets the first clip's graph. Importing this module adds it to
``faults.BY_NAME``, beside the faults every training cell has."""

from __future__ import annotations

from portbench import faults


def one_graph():
    """The input pipeline's per-clip supports (S, B, N, N) all become clip
    0's, in the step and wherever else the pipeline builds them."""
    from eeg_gnn_tpu_torch.data.device_pipeline import DevicePipeline

    whole = DevicePipeline._supports

    def first(self, *args, **kwargs):
        sup = whole(self, *args, **kwargs)
        if sup.dim() != 4:
            return sup
        return sup[:, :1].expand_as(sup).contiguous()

    return faults._patched(DevicePipeline, "_supports", first)


faults.BY_NAME.setdefault("one_graph", one_graph)
