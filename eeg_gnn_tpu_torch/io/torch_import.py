"""Reference PyTorch checkpoints into the port's DCRNN state dicts
(``eeg_gnn_tpu/io/torch_import.py``).

The reference ships its pretrained SSL encoder-decoders as
``pretrained/*.pth.tar`` files holding ``{'model_state': ...}`` (its
README.md:102) and saves training checkpoints as ``{'epoch',
'model_state', 'optimizer_state'}`` (utils.py:130-163). Its weight layout
is the port's (``ops/diffusion.py``), so an import is a renaming:

- ``encoder.encoding_cells.{i}.dconv_gate.weight`` / ``.biases`` (not
  ``.bias``) and ``dconv_candidate`` -> ``encoder.{i}.{gate,cand}_{w,b}``;
- ``fc.*`` -> ``fc.*``;
- ``decoder.decoding_cells.0`` -> ``decoder.layer0``; the reference's
  decoder layers >= 1 are one module object, whose tensors its state dict
  stores under every index >= 1: layer 1 is read as ``decoder.shared``;
- ``decoder.projection_layer.*`` -> ``decoder.proj.*``.

The baselines' importers (LSTM, CNN-LSTM, Dense-CNN) come with their
models (ROADMAP.md, Queue 1, item 6).
"""

from __future__ import annotations

from typing import Dict

import torch

_CELL = (("gate_w", "dconv_gate.weight"), ("gate_b", "dconv_gate.biases"),
         ("cand_w", "dconv_candidate.weight"),
         ("cand_b", "dconv_candidate.biases"))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's model state: ``{'model_state': ...}`` or a
    bare state dict, as float32 CPU tensors. Read with
    ``weights_only=True``: tensors and plain containers only, no code."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().float() for k, v in state.items()}


def _cell_from(state, prefix: str, to: str) -> Dict[str, torch.Tensor]:
    return {f"{to}.{ours}": state[f"{prefix}.{ref}"] for ours, ref in _CELL}


def _encoder_from(state, num_layers: int) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(num_layers):
        out.update(_cell_from(state, f"encoder.encoding_cells.{i}",
                              f"encoder.{i}"))
    return out


def import_classification_params(state, num_rnn_layers: int
                                 ) -> Dict[str, torch.Tensor]:
    """A ``DCRNNModel_classification`` state dict -> the state dict of the
    port's ``DCRNNClassifier``."""
    out = _encoder_from(state, num_rnn_layers)
    out["fc.weight"] = state["fc.weight"]
    out["fc.bias"] = state["fc.bias"]
    return out


def import_next_time_pred_params(state, num_rnn_layers: int
                                 ) -> Dict[str, torch.Tensor]:
    """A ``DCRNNModel_nextTimePred`` state dict -> the state dict of the
    port's ``DCRNNNextTimePred`` (the tied cell read from layer 1)."""
    out = _encoder_from(state, num_rnn_layers)
    out.update(_cell_from(state, "decoder.decoding_cells.0",
                          "decoder.layer0"))
    if num_rnn_layers > 1:
        out.update(_cell_from(state, "decoder.decoding_cells.1",
                              "decoder.shared"))
    out["decoder.proj.weight"] = state["decoder.projection_layer.weight"]
    out["decoder.proj.bias"] = state["decoder.projection_layer.bias"]
    return out
