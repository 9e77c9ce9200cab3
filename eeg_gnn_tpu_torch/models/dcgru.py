"""DCGRU: Diffusion-Convolutional GRU cell and encoder.

Reference semantics: ``model/cell.py:121-225`` (cell) and
``model/model.py:48-109`` (encoder), as in ``eeg_gnn_tpu/models/dcgru.py``.

Each layer runs over the whole sequence at once (:func:`_layer_scan`):

- ``recurrence="pallas"`` with ``input_fusion``: the CUDA kernel that
  diffuses and projects the raw layer input itself
  (``ops/cuda_recurrent.dcgru_recurrence_xin_fwd``);
- ``recurrence="pallas"`` without it: the input projection is one set of
  GEMMs over all T (``compute_x_proj``) feeding the hoisted-input kernel
  (``dcgru_recurrence_fwd``);
- ``recurrence="stacked"``: the same hoisted projection feeding the plain
  operator-stacked loop with its hand-written BPTT (``ops/recurrent.py``).

When autograd records (training), the ``pallas`` branches run through the
autograd Functions of ``ops/cuda_recurrent.py``, whose forward kernels save
the ru/c residuals and whose backward is the BPTT kernel; otherwise
(serving, ``torch.inference_mode``) they call the forward kernels without
residuals. On CPU tensors the kernel wrappers compute with their plain
versions.

Parameter layout matches reference checkpoints exactly (weight row
``d*M + m``). Reference init quirk, reproduced deliberately:
``DiffusionGraphConv`` is always built with ``bias_start=0.0`` — the
``bias_start=1.0`` passed by ``DCGRUCell.forward`` (cell.py:197) is an
unused argument of the forward method — so gate biases init to zero.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.ops.cuda_recurrent import (
    dcgru_layer_recurrence_fused,
    dcgru_layer_recurrence_xin,
    dcgru_recurrence_fwd,
    dcgru_recurrence_xin_fwd,
)
from eeg_gnn_tpu_torch.ops.diffusion import chebyshev_diffusion
from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    chebyshev_operators,
    dcgru_layer_recurrence,
    rearrange_hidden_weight,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DCGRUConfig:
    """Static configuration of a DCGRU cell."""

    input_dim: int
    num_units: int
    max_diffusion_step: int
    num_nodes: int
    num_supports: int
    activation: str = "tanh"  # 'tanh' | 'relu' | 'linear'
    compute_dtype: str = "float32"  # stream dtype of the recurrence
    recurrence: str = "pallas"  # 'pallas' (CUDA kernels) | 'stacked'
    input_fusion: bool = False  # input diffusion + projection in-kernel

    @property
    def num_matrices(self) -> int:
        return self.num_supports * self.max_diffusion_step + 1


def xavier_normal(generator: torch.Generator, shape, gain: float):
    """Xavier-normal init, ``nn.init.xavier_normal_`` semantics (reference
    cell.py:47: gain=1.414)."""
    fan_in, fan_out = shape[0], shape[1]
    std = gain * (2.0 / (fan_in + fan_out)) ** 0.5
    return std * torch.randn(shape, generator=generator, dtype=torch.float32)


def init_dcgru_cell(generator: torch.Generator,
                    cfg: DCGRUConfig) -> Dict[str, torch.Tensor]:
    """One cell's params in reference layout (cell.py:40-48), on the CPU."""
    d_total = cfg.input_dim + cfg.num_units
    m = cfg.num_matrices
    return {
        "gate_w": xavier_normal(generator, (d_total * m, 2 * cfg.num_units),
                                1.414),
        "gate_b": torch.zeros(2 * cfg.num_units),
        "cand_w": xavier_normal(generator, (d_total * m, cfg.num_units),
                                1.414),
        "cand_b": torch.zeros(cfg.num_units),
    }


def _split_weight(cfg: DCGRUConfig, w):
    """Split a (D_total*M, out) weight into input rows / hidden rows (rows
    are (d, m), d-major over the concat [inputs, state])."""
    cut = cfg.input_dim * cfg.num_matrices
    return w[:cut], w[cut:]


def _flat(stacked):
    """(..., N, D, M) -> (..., N, D*M) in reference d-major layout."""
    return stacked.reshape(*stacked.shape[:-2], -1)


def dcgru_cell_apply(cfg: DCGRUConfig, params, supports, x, h):
    """One DCGRU step with full reference semantics (cell.py:182-210).

    supports: (S, ..., N, N); x: (..., N, input_dim); h: (..., N, num_units).
    Returns the new hidden state (..., N, num_units).
    """
    act, _ = _act_pair(cfg.activation)
    h_units = cfg.num_units
    k = cfg.max_diffusion_step
    xh_feat = _flat(chebyshev_diffusion(supports, torch.cat([x, h], -1), k))
    ru = torch.sigmoid(torch.matmul(xh_feat, params["gate_w"])
                       + params["gate_b"])
    r, u = ru[..., :h_units], ru[..., h_units:]
    xrh_feat = _flat(chebyshev_diffusion(supports, torch.cat([x, r * h], -1),
                                         k))
    c = act(torch.matmul(xrh_feat, params["cand_w"]) + params["cand_b"])
    return u * h + (1.0 - u) * c


def compute_x_proj(supports, x, wx, max_diffusion_step: int):
    """Input contribution of all T steps at once: ``sum_m (T_m x) @ W_m``
    as per-term GEMMs, with the Chebyshev term recurrence (and its
    cross-support carry-over quirk) of ``chebyshev_diffusion``.

    supports and x arrive in the compute dtype; wx is (Din, M, 3H) in it.
    Terms accumulate in float32; the result is cast to x's dtype.
    """
    x_proj = torch.matmul(x, wx[:, 0]).float()
    mi = 1
    if max_diffusion_step > 0:
        x0_, x1_ = x, None
        for s in supports:
            x1_ = torch.matmul(s, x0_)
            x_proj += torch.matmul(x1_, wx[:, mi]).float()
            mi += 1
            for _ in range(2, max_diffusion_step + 1):
                x2 = 2.0 * torch.matmul(s, x1_) - x0_
                x_proj += torch.matmul(x2, wx[:, mi]).float()
                mi += 1
                x1_, x0_ = x2, x1_
    return x_proj.to(x.dtype)


def _layer_scan(cfg: DCGRUConfig, params, supports, x_seq, h0):
    """Run one DCGRU layer over time.

    x_seq: (T, B, N, input_dim); h0: (B, N, num_units) float32.
    Returns (h_last, h_seq) with h_seq (T, B, N, num_units).
    """
    h_units = cfg.num_units
    k = cfg.max_diffusion_step
    m = cfg.num_matrices
    din = x_seq.shape[-1]
    stream = _DTYPES[cfg.compute_dtype]

    wx_gate, wh_gate = _split_weight(cfg, params["gate_w"])
    wx_cand, wh_cand = _split_weight(cfg, params["cand_w"])
    x_c = x_seq.to(stream).contiguous()
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_seq, h0, *params.values()))

    a_ops = chebyshev_operators(supports.float(), k)
    if a_ops.ndim == 3:  # shared (N, N) graph: broadcast batch dim
        a_ops = a_ops[:, None]
    a_ops = a_ops.contiguous()
    wh_args = (
        rearrange_hidden_weight(wh_gate, h_units, m).contiguous(),
        rearrange_hidden_weight(wh_cand, h_units, m).contiguous(),
        params["gate_b"], params["cand_b"], h0,
    )

    if cfg.recurrence == "pallas" and cfg.input_fusion:
        # reference-layout (d, m)-major input rows -> m-major (M*D, O)
        wxg_f = wx_gate.reshape(din, m, -1).transpose(0, 1).reshape(m * din, -1)
        wxc_f = wx_cand.reshape(din, m, -1).transpose(0, 1).reshape(m * din, -1)
        args = (x_c, a_ops, wxg_f.contiguous(), wxc_f.contiguous(), *wh_args,
                cfg.activation)
        if train:
            h_seq = dcgru_layer_recurrence_xin(*args)
        else:
            h_seq, _, _ = dcgru_recurrence_xin_fwd(*args)
        return h_seq[-1], h_seq

    wx = torch.cat([wx_gate, wx_cand], dim=1).reshape(din, m, -1)
    x_proj = compute_x_proj(supports.to(stream), x_c, wx.to(stream), k)
    if cfg.recurrence == "pallas":
        args = (x_proj.contiguous(), a_ops, *wh_args, cfg.activation)
        if train:
            h_seq = dcgru_layer_recurrence_fused(*args)
        else:
            h_seq, _, _ = dcgru_recurrence_fwd(*args)
        return h_seq[-1], h_seq
    if cfg.recurrence == "stacked":
        x_proj = x_proj.float()
        return dcgru_layer_recurrence(
            a_ops, x_proj[..., :2 * h_units], x_proj[..., 2 * h_units:],
            *wh_args, cfg.activation)
    raise ValueError(f"unknown recurrence {cfg.recurrence!r} "
                     "(the port has 'pallas' and 'stacked')")


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_configs(input_dim, num_units, max_diffusion_step, num_nodes,
                    num_supports, num_layers, activation="tanh",
                    compute_dtype="float32", recurrence="pallas",
                    input_fusion=False) -> List[DCGRUConfig]:
    """Per-layer cell configs: layer 0 consumes input_dim, the rest
    num_units (reference model.py:58-79)."""
    mk = lambda d: DCGRUConfig(d, num_units, max_diffusion_step, num_nodes,
                               num_supports, activation, compute_dtype,
                               recurrence, input_fusion)
    return [mk(input_dim)] + [mk(num_units)] * (num_layers - 1)


def encoder_init(generator: torch.Generator, cfgs):
    return [init_dcgru_cell(generator, c) for c in cfgs]


def encoder_apply(cfgs, params, supports, x_seq, h0: Optional[torch.Tensor] = None):
    """Stacked DCGRU encoder over a full sequence.

    Args:
        cfgs: per-layer DCGRUConfig list; params: per-layer cell params.
        supports: (S, ..., N, N).
        x_seq: (T, B, N, input_dim), time-major.
        h0: optional (L, B, N, num_units) initial states (zeros by default).

    Returns:
        (hidden_stack, top_seq): (L, B, N, H) last state per layer, in
        x_seq's dtype, and the top layer's output sequence (T, B, N, H) in
        the stream dtype.
    """
    _, b, n, _ = x_seq.shape
    h_units = cfgs[0].num_units
    cur = x_seq
    lasts = []
    for i, (cfg, p) in enumerate(zip(cfgs, params)):
        # the recurrent state is always f32, whatever the stream dtype
        h_init = (torch.zeros((b, n, h_units), dtype=torch.float32,
                              device=x_seq.device)
                  if h0 is None else h0[i].float().contiguous())
        h_last, cur = _layer_scan(cfg, p, supports, cur, h_init)
        lasts.append(h_last)
    return torch.stack(lasts, dim=0).to(x_seq.dtype), cur


class DCGRUCell(nn.Module):
    """Parameter holder of one cell (reference layout, float32)."""

    def __init__(self, cfg: DCGRUConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is not None:
            init = init_dcgru_cell(generator, cfg)
        else:  # a template whose values come from load_state_dict
            d_total = (cfg.input_dim + cfg.num_units) * cfg.num_matrices
            h = cfg.num_units
            init = {"gate_w": torch.zeros(d_total, 2 * h),
                    "gate_b": torch.zeros(2 * h),
                    "cand_w": torch.zeros(d_total, h),
                    "cand_b": torch.zeros(h)}
        for name, value in init.items():
            self.register_parameter(name, nn.Parameter(value))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"gate_w": self.gate_w, "gate_b": self.gate_b,
                "cand_w": self.cand_w, "cand_b": self.cand_b}
