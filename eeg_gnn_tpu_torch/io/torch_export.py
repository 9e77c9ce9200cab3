"""The port's DCRNN state dicts as reference PyTorch checkpoints
(``eeg_gnn_tpu/io/torch_export.py``): the inverse of
``io/torch_import.py``, so a model trained here loads into the upstream
implementation (the same weight layout under the reference's names)."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from eeg_gnn_tpu_torch.io.torch_import import _CELL


def _cell_to(out, prefix: str, state, frm: str):
    for ours, ref in _CELL:
        out[f"{prefix}.{ref}"] = state[f"{frm}.{ours}"].detach().float().cpu()


def _num_layers(state) -> int:
    return 1 + max(int(k.split(".")[1]) for k in state
                   if k.startswith("encoder."))


def export_classification_state(state: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A ``DCRNNClassifier`` state dict -> a ``DCRNNModel_classification``
    state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(_num_layers(state)):
        _cell_to(out, f"encoder.encoding_cells.{i}", state, f"encoder.{i}")
    out["fc.weight"] = state["fc.weight"].detach().float().cpu()
    out["fc.bias"] = state["fc.bias"].detach().float().cpu()
    return out


def export_next_time_pred_state(state: Mapping[str, torch.Tensor],
                                num_rnn_layers: int
                                ) -> Dict[str, torch.Tensor]:
    """A ``DCRNNNextTimePred`` state dict -> a ``DCRNNModel_nextTimePred``
    state dict: the tied decoder cell is written under every layer index
    >= 1, as torch's state_dict of the reference's shared module does."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_rnn_layers):
        _cell_to(out, f"encoder.encoding_cells.{i}", state, f"encoder.{i}")
    _cell_to(out, "decoder.decoding_cells.0", state, "decoder.layer0")
    for i in range(1, num_rnn_layers):
        _cell_to(out, f"decoder.decoding_cells.{i}", state, "decoder.shared")
    out["decoder.projection_layer.weight"] = \
        state["decoder.proj.weight"].detach().float().cpu()
    out["decoder.projection_layer.bias"] = \
        state["decoder.proj.bias"].detach().float().cpu()
    return out


def save_torch_checkpoint(path: str, state: Mapping[str, torch.Tensor],
                          epoch: int = 0):
    """Write a ``.pth.tar`` that the reference's ``load_model_checkpoint``
    reads (utils.py:156-163): ``{'epoch', 'model_state',
    'optimizer_state'}``, the optimizer state empty."""
    torch.save({"epoch": epoch,
                "model_state": {k: v.contiguous() for k, v in state.items()},
                "optimizer_state": {}}, path)
