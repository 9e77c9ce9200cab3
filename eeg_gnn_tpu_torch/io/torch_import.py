"""Reference PyTorch checkpoints into the port's state dicts
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

The baselines' modules carry the reference's submodule names
(``models/{lstm,cnnlstm,densecnn}.py``), so their importers select the
model's keys unchanged: ``lstm.*`` and ``fc.*`` (``LSTMModel``);
``conv1``, ``conv2``, ``fc1``, ``lstm``, ``fc2`` (``CNN_LSTM``);
``dense_inception.*`` (``DenseCNN``), whose BatchNorm running statistics
come across as buffers, its ``num_batches_tracked`` set to 0 where the
file has none.
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


def _select(state, keys) -> Dict[str, torch.Tensor]:
    missing = [k for k in keys if k not in state]
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:4]}"
                       + (" ..." if len(missing) > 4 else ""))
    return {k: state[k] for k in keys}


def _lstm_keys(num_layers: int):
    return [f"lstm.{name}_l{i}" for i in range(num_layers)
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]


def import_lstm_params(state, num_layers: int) -> Dict[str, torch.Tensor]:
    """A reference ``LSTMModel`` state dict (model/lstm.py) -> the state
    dict of the port's ``LSTMModel``."""
    return _select(state, _lstm_keys(num_layers) + ["fc.weight", "fc.bias"])


def import_cnnlstm_params(state) -> Dict[str, torch.Tensor]:
    """A reference ``CNN_LSTM`` state dict (model/cnnlstm.py) -> the state
    dict of the port's ``CNNLSTM`` (2 LSTM layers)."""
    return _select(state, [f"{m}.{p}" for m in ("conv1", "conv2", "fc1",
                                                "fc2")
                           for p in ("weight", "bias")] + _lstm_keys(2))


def import_densecnn_params(state, template) -> Dict[str, torch.Tensor]:
    """A reference ``DenseCNN`` state dict (model/densecnn.py +
    model/dense_inception/*) -> the state dict of the port's ``DenseCNN``,
    whose keys ``template`` (its ``state_dict()``) names: the parameters
    and the BatchNorm running statistics; ``num_batches_tracked`` is 0
    where the file has none (the JAX importer's ``(params, state)``)."""
    bn_count = "dense_inception.fcbn1.num_batches_tracked"
    out = _select(state, [k for k in template if k != bn_count])
    out[bn_count] = state.get(bn_count, torch.tensor(0)).long()
    return out


def import_params_for(cfg, state) -> Dict[str, torch.Tensor]:
    """The state dict of the classifier of ``cfg`` (an ``ExperimentConfig``:
    DCRNN or a baseline, by ``model_name``) from a reference state dict
    (JAX ``serve.load_params_for``)."""
    if cfg.model_name == "dcrnn":
        return import_classification_params(state, cfg.num_rnn_layers)
    if cfg.model_name == "lstm":
        return import_lstm_params(state, cfg.num_rnn_layers)
    if cfg.model_name == "cnnlstm":
        return import_cnnlstm_params(state)
    if cfg.model_name == "densecnn":
        from eeg_gnn_tpu_torch.models.registry import build_model

        return import_densecnn_params(state, build_model(cfg).state_dict())
    raise NotImplementedError(cfg.model_name)
