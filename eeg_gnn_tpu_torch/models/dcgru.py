"""DCGRU: Diffusion-Convolutional GRU cell, encoder and seq2seq decoder.

Reference semantics: ``model/cell.py:121-225`` (cell),
``model/model.py:48-109`` (encoder) and ``model/model.py:112-204``
(decoder), as in ``eeg_gnn_tpu/models/dcgru.py``.

Each encoder layer runs over the whole sequence at once (:func:`_layer_scan`):

- ``recurrence="pallas"`` with ``input_fusion``: the CUDA kernel that
  diffuses and projects the raw layer input itself
  (``ops/cuda_recurrent.dcgru_recurrence_xin_fwd``);
- ``recurrence="pallas"`` without it: the input projection is one set of
  GEMMs over all T (``compute_x_proj``) feeding the hoisted-input kernel
  (``dcgru_recurrence_fwd``);
- ``recurrence="stacked"``: the same hoisted projection feeding the plain
  operator-stacked loop with its hand-written BPTT (``ops/recurrent.py``);
- ``use_pallas`` (whatever the recurrence) or ``recurrence="naive"``: the
  hoisted projection feeding a per-step Python loop (:func:`_step_scan`)
  whose hidden diffusion convs run the fused diffusion-conv kernel
  (``ops/cuda_kernels.py``) with ``use_pallas`` and per-clip supports,
  and ``chebyshev_diffusion`` + matmul otherwise.

The decoder (:func:`decoder_apply`) runs through the CUDA kernels of
``ops/cuda_decoder.py`` with ``recurrence="pallas"`` (the forward one
launch over all T_out steps and all layers, its BPTT a state loop and
bulk dW and dWp products), and as a plain scan of
:func:`dcgru_cell_apply_ops` under autograd with ``"stacked"`` or with
dropout in training. The scheduled-sampling draws are one (T_out,) force
vector drawn from a ``torch.Generator`` before the loop, or given.

When autograd records (training), the ``pallas`` branches run through the
autograd Functions of ``ops/cuda_recurrent.py`` and ``ops/cuda_decoder.py``,
whose forward kernels save their residuals and whose backward runs the
BPTT kernels; otherwise (serving, ``torch.inference_mode``) they call the
forward kernels without residuals. On CPU tensors the kernel wrappers
compute with their plain versions.

Parameter layout matches reference checkpoints exactly (weight row
``d*M + m``), including the decoder quirk that layers >= 1 share one cell
(reference model.py:126-143). Reference init quirk, reproduced
deliberately: ``DiffusionGraphConv`` is always built with
``bias_start=0.0`` — the ``bias_start=1.0`` passed by ``DCGRUCell.forward``
(cell.py:197) is an unused argument of the forward method — so gate
biases init to zero.
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
from eeg_gnn_tpu_torch.ops.cuda_decoder import (
    dcgru_decoder_fwd,
    dcgru_decoder_recurrence,
)
from eeg_gnn_tpu_torch.ops.cuda_kernels import (
    fused_diffusion_conv,
    fused_diffusion_conv_fwd,
    rearrange_weight,
    stage_fdc_operands,
)
from eeg_gnn_tpu_torch.ops.diffusion import chebyshev_diffusion
from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    _apply_ops,
    _contract_w,
    chebyshev_operators,
    dcgru_layer_recurrence,
    rearrange_hidden_weight,
)
from eeg_gnn_tpu_torch.parallel.mesh import rand

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_RECURRENCES = ("pallas", "stacked", "naive")


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
    recurrence: str = "pallas"  # 'pallas' (CUDA kernels) | 'stacked' | 'naive'
    input_fusion: bool = False  # input diffusion + projection in-kernel
    use_pallas: bool = False  # per-step loop, fused diffusion-conv kernel

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


def _hoisted_x_proj(cfg: DCGRUConfig, supports, x_c, wx_gate, wx_cand,
                    stream):
    """:func:`compute_x_proj` of the layer's input rows, gate and candidate
    side by side: (T, B, N, 3H) in the stream dtype."""
    wx = torch.cat([wx_gate, wx_cand], dim=1).reshape(
        x_c.shape[-1], cfg.num_matrices, -1)
    return compute_x_proj(supports.to(stream), x_c, wx.to(stream),
                          cfg.max_diffusion_step)


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

    if cfg.recurrence not in _RECURRENCES:
        raise ValueError(f"unknown recurrence {cfg.recurrence!r} "
                         f"(the port has {', '.join(_RECURRENCES)})")
    wx_gate, wh_gate = _split_weight(cfg, params["gate_w"])
    wx_cand, wh_cand = _split_weight(cfg, params["cand_w"])
    x_c = x_seq.to(stream).contiguous()
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_seq, h0, *params.values()))

    if cfg.use_pallas or cfg.recurrence == "naive":
        # JAX models/dcgru.py:303-344: use_pallas overrides recurrence and
        # input_fusion
        x_proj = _hoisted_x_proj(cfg, supports, x_c, wx_gate, wx_cand,
                                 stream)
        return _step_scan(cfg, params, supports, x_proj, wh_gate, wh_cand,
                          h0, train)

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

    x_proj = _hoisted_x_proj(cfg, supports, x_c, wx_gate, wx_cand, stream)
    if cfg.recurrence == "pallas":
        args = (x_proj.contiguous(), a_ops, *wh_args, cfg.activation)
        if train:
            h_seq = dcgru_layer_recurrence_fused(*args)
        else:
            h_seq, _, _ = dcgru_recurrence_fwd(*args)
        return h_seq[-1], h_seq
    x_proj = x_proj.float()
    return dcgru_layer_recurrence(
        a_ops, x_proj[..., :2 * h_units], x_proj[..., 2 * h_units:],
        *wh_args, cfg.activation)


def _step_scan(cfg: DCGRUConfig, params, supports, x_proj, wh_gate, wh_cand,
               h0, train: bool):
    """The per-step loop of JAX ``_layer_scan`` (``models/dcgru.py:303-344``)
    on the hoisted input projection: each step's hidden transforms are one
    diffusion conv each, of h (gate) and of r*h (candidate).

    With ``use_pallas`` and per-clip (S, B, N, N) supports they are the
    fused diffusion-conv kernel (two launches per step: its autograd
    Function when ``train``, the bare forward wrapper otherwise), its
    operands (the supports, the gate and candidate weights) staged once
    here for all T steps; with a
    shared (S, N, N) graph, or ``use_pallas`` off, ``chebyshev_diffusion``
    + matmul. The gate and candidate inputs and the state are float32
    whatever the stream dtype, so h_seq (T, B, N, H) is float32.
    """
    h_units = cfg.num_units
    k = cfg.max_diffusion_step
    act, _ = _act_pair(cfg.activation)
    gate_b, cand_b = params["gate_b"], params["cand_b"]
    if cfg.use_pallas and supports.ndim == 4:
        sup = supports.float().contiguous()
        w_gate = rearrange_weight(wh_gate, h_units, cfg.num_matrices)
        w_cand = rearrange_weight(wh_cand, h_units, cfg.num_matrices)
        w_gate, w_cand = w_gate.contiguous(), w_cand.contiguous()
        sup_f, (w_gate_f, w_cand_f) = stage_fdc_operands(sup, w_gate, w_cand)
        conv = fused_diffusion_conv if train else fused_diffusion_conv_fwd
        hidden_gate = lambda h: conv(sup, h, w_gate, gate_b, k,
                                     (sup_f, w_gate_f))
        hidden_cand = lambda rh: conv(sup, rh, w_cand, cand_b, k,
                                      (sup_f, w_cand_f))
    else:
        hidden_gate = lambda h: torch.matmul(
            _flat(chebyshev_diffusion(supports, h, k)), wh_gate) + gate_b
        hidden_cand = lambda rh: torch.matmul(
            _flat(chebyshev_diffusion(supports, rh, k)), wh_cand) + cand_b

    gate_x = x_proj[..., :2 * h_units].float()
    cand_x = x_proj[..., 2 * h_units:].float()
    h = h0
    h_seq = []
    for t in range(x_proj.shape[0]):
        ru = torch.sigmoid(gate_x[t] + hidden_gate(h))
        r, u = ru[..., :h_units], ru[..., h_units:]
        c = act(cand_x[t] + hidden_cand(r * h))
        h = u * h + (1.0 - u) * c
        h_seq.append(h)
    return h, torch.stack(h_seq)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_configs(input_dim, num_units, max_diffusion_step, num_nodes,
                    num_supports, num_layers, activation="tanh",
                    compute_dtype="float32", recurrence="pallas",
                    input_fusion=False, use_pallas=False
                    ) -> List[DCGRUConfig]:
    """Per-layer cell configs: layer 0 consumes input_dim, the rest
    num_units (reference model.py:58-79)."""
    mk = lambda d: DCGRUConfig(d, num_units, max_diffusion_step, num_nodes,
                               num_supports, activation, compute_dtype,
                               recurrence, input_fusion, use_pallas)
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
        the stream dtype (float32 from the per-step loop of ``use_pallas``
        or ``recurrence="naive"``, as in JAX).
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


def dcgru_cell_apply_ops(cfg: DCGRUConfig, w_gate_r, w_cand_r, gate_b,
                         cand_b, a_ops, x, h):
    """One DCGRU step on a precomputed operator stack, in plain torch ops
    (autograd differentiates it): the decoder scan's cell.

    w_gate_r / w_cand_r: (M, D_total, 2H / H) rearranged reference-layout
    weights (``rearrange_hidden_weight(w, D_total, M)``); a_ops: (M, B or
    1, N, N); x: (B, N, input_dim); h: (B, N, num_units).
    """
    act, _ = _act_pair(cfg.activation)
    h_units = cfg.num_units
    xh = torch.cat([x, h], dim=-1)
    ru = torch.sigmoid(_contract_w(_apply_ops(a_ops, xh), w_gate_r) + gate_b)
    r, u = ru[..., :h_units], ru[..., h_units:]
    xrh = torch.cat([x, r * h], dim=-1)
    c = act(_contract_w(_apply_ops(a_ops, xrh), w_cand_r) + cand_b)
    return u * h + (1.0 - u) * c


def dropout(x, rate: float, training: bool,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout (``eeg_gnn_tpu/models/dcrnn.py:81-86``) whose mask
    comes from ``generator`` (on x's device; axis 0 is the batch, drawn
    whole under a data-parallel step, ``parallel.mesh.rand``). JAX's PRNG
    stream cannot be reproduced, so parity tests run with rate 0, the
    flagship value."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = rand(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Decoder (seq2seq with scheduled sampling)
# ---------------------------------------------------------------------------


def decoder_init(generator: torch.Generator, input_dim, num_units,
                 max_diffusion_step, num_nodes, num_supports, num_layers,
                 output_dim, activation="tanh"):
    """Decoder params on the CPU, as ``eeg_gnn_tpu/models/dcgru.py:473-496``:
    layers >= 1 share ONE cell (reference model.py:126-143), stored once
    under ``shared`` (only when num_layers > 1); the projection keeps the
    ``nn.Linear`` layout, weight (output_dim, num_units), and its uniform
    init. Returns (params, (cfg_layer0, cfg_shared))."""
    cfg0 = DCGRUConfig(input_dim, num_units, max_diffusion_step, num_nodes,
                       num_supports, activation)
    cfg_shared = DCGRUConfig(num_units, num_units, max_diffusion_step,
                             num_nodes, num_supports, activation)
    params = {"layer0": init_dcgru_cell(generator, cfg0)}
    if num_layers > 1:
        params["shared"] = init_dcgru_cell(generator, cfg_shared)
    bound = 1.0 / (num_units ** 0.5)
    params["proj_w"] = torch.empty(output_dim, num_units).uniform_(
        -bound, bound, generator=generator)
    params["proj_b"] = torch.empty(output_dim).uniform_(
        -bound, bound, generator=generator)
    return params, (cfg0, cfg_shared)


def draw_force(t_out: int, teacher_forcing_ratio, generator, device):
    """The per-step force vector (T_out,) float32: step t feeds the ground
    truth to step t+1 with probability ``teacher_forcing_ratio`` (a float
    or a 0-d tensor), drawn from ``generator`` on ``device``, all at once
    and with no host sync; all zeros (eval semantics) when it is None."""
    if teacher_forcing_ratio is None:
        return torch.zeros(t_out, device=device)
    draws = torch.rand(t_out, generator=generator, device=device)
    return (draws < teacher_forcing_ratio).float()


def decoder_kernel_weights(cfg0: DCGRUConfig, params, num_layers):
    """The decoder params in the kernels' layout, as ``_decoder_pallas``
    (JAX ``models/dcgru.py:631-650``) re-packs them: per cell (layer 0,
    then the shared one, None when ``num_layers == 1``) the input rows
    m-major (M*Din, O), the hidden rows (M*H, O) and the two biases; then
    ``proj_w.T`` (H, D) and ``proj_b``: the 14 weight arguments of
    ``ops/cuda_decoder.dcgru_decoder_fwd``."""
    m, h, d = cfg0.num_matrices, cfg0.num_units, cfg0.input_dim

    def split_mmajor(p_cell, d_in):
        cut = d_in * m
        wx = [p_cell[k][:cut].reshape(d_in, m, -1).transpose(0, 1)
              .reshape(m * d_in, -1) for k in ("gate_w", "cand_w")]
        wh = [rearrange_hidden_weight(p_cell[k][cut:], h, m).reshape(m * h, -1)
              for k in ("gate_w", "cand_w")]
        return tuple(w.contiguous() for w in (*wx, *wh)) + (
            p_cell["gate_b"], p_cell["cand_b"])

    shared = (split_mmajor(params["shared"], h) if num_layers > 1
              else (None,) * 6)
    return (*split_mmajor(params["layer0"], d), *shared,
            params["proj_w"].t().contiguous(), params["proj_b"])


def _decoder_kernels(cfg0: DCGRUConfig, params, a_ops, dec_inputs, force,
                     h0_stack, num_layers):
    """The decoder through the kernels of ``ops/cuda_decoder.py``, as
    ``_decoder_pallas`` (JAX ``models/dcgru.py:618-658``) calls them:
    weights re-packed by :func:`decoder_kernel_weights`, x in the stream
    dtype, the output cast to f32."""
    args = (a_ops, dec_inputs.to(_DTYPES[cfg0.compute_dtype]).contiguous(),
            force.float().contiguous(),
            *decoder_kernel_weights(cfg0, params, num_layers),
            h0_stack.float().contiguous(), num_layers, cfg0.activation)
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in args):
        out = dcgru_decoder_recurrence(*args)
    else:
        out, *_ = dcgru_decoder_fwd(*args)
    return out.float()


def decoder_apply(cfgs, params, supports, dec_inputs, h0_stack, num_layers,
                  *, teacher_forcing_ratio=None, dropout_rate=0.0,
                  generator: Optional[torch.Generator] = None,
                  training=False, force=None):
    """Seq2seq DCGRU decoder with GO-symbol start and scheduled sampling
    (reference ``DCGRUDecoder.forward``, model.py:149-204).

    Args:
        cfgs: (cfg_layer0, cfg_shared) as :func:`decoder_init` returns them,
            with the model's ``compute_dtype`` and ``recurrence``.
        params: {"layer0", "shared" (num_layers > 1), "proj_w", "proj_b"}.
        supports: (S, ..., N, N).
        dec_inputs: (T_out, B, N, output_dim) ground truth, time-major.
        h0_stack: (L, B, N, H) the encoder's final states.
        teacher_forcing_ratio: per-step probability of feeding the ground
            truth (None: never, eval semantics).
        dropout_rate / training: dropout before the projection.
        generator: draws the force vector and the dropout masks.
        force: (T_out,) an explicit force vector in place of the draw (the
            parity tests feed the one JAX drew).

    Returns:
        (T_out, B, N, output_dim) float32 predictions.

    ``recurrence="pallas"`` runs the two decoder kernels (on the CPU their
    plain versions), unless dropout is active in training, which, as in
    JAX (``:569``), takes the plain stacked scan; so do ``"stacked"`` and
    ``"naive"``. ``use_pallas`` does not reach the decoder.
    """
    cfg0, cfg_shared = cfgs
    t_out = dec_inputs.shape[0]
    use_dropout = training and dropout_rate > 0.0
    if force is None:
        force = draw_force(t_out, teacher_forcing_ratio, generator,
                           dec_inputs.device)
    m = cfg0.num_matrices
    a_ops = chebyshev_operators(supports.float(), cfg0.max_diffusion_step)
    if a_ops.ndim == 3:  # shared (N, N) graph: broadcast batch dim
        a_ops = a_ops[:, None]
    a_ops = a_ops.contiguous()
    if cfg0.recurrence == "pallas" and not use_dropout:
        return _decoder_kernels(cfg0, params, a_ops, dec_inputs, force,
                                h0_stack, num_layers)
    if cfg0.recurrence not in _RECURRENCES:
        raise ValueError(f"unknown recurrence {cfg0.recurrence!r} "
                         f"(the port has {', '.join(_RECURRENCES)})")

    cells = []
    for i in range(num_layers):
        cfg_i = cfg0 if i == 0 else cfg_shared
        p_i = params["layer0"] if i == 0 else params["shared"]
        d_total = cfg_i.input_dim + cfg_i.num_units
        cells.append((cfg_i,
                      rearrange_hidden_weight(p_i["gate_w"], d_total, m),
                      rearrange_hidden_weight(p_i["cand_w"], d_total, m),
                      p_i["gate_b"], p_i["cand_b"]))
    # the carry is f32 whatever the inputs' dtype
    h = list(h0_stack.float().unbind(0))
    cur = torch.zeros(dec_inputs.shape[1:], dtype=torch.float32,
                      device=dec_inputs.device)
    outputs = []
    for t in range(t_out):
        out = cur
        for i, cell in enumerate(cells):
            h[i] = dcgru_cell_apply_ops(cell[0], *cell[1:], a_ops, out, h[i])
            out = h[i]
        pre = dropout(out, dropout_rate, use_dropout, generator)
        projected = torch.matmul(pre, params["proj_w"].t()) + params["proj_b"]
        outputs.append(projected)
        cur = torch.where(force[t] > 0, dec_inputs[t].float(), projected)
    return torch.stack(outputs)


class DCGRUDecoder(nn.Module):
    """Parameter holder of the decoder: ``layer0``, ``shared`` (only with
    more than one layer) and the projection ``proj`` (``nn.Linear``
    layout). ``generator`` draws them as :func:`decoder_init`; without one
    they are zeros, a template for ``load_state_dict``."""

    def __init__(self, cfgs, num_layers: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg0, cfg_shared = cfgs
        self.layer0 = DCGRUCell(cfg0)
        if num_layers > 1:
            self.shared = DCGRUCell(cfg_shared)
        self.proj = nn.Linear(cfg0.num_units, output_dim)
        if generator is None:
            nn.init.zeros_(self.proj.weight)
            nn.init.zeros_(self.proj.bias)
            return
        init, _ = decoder_init(generator, cfg0.input_dim, cfg0.num_units,
                               cfg0.max_diffusion_step, cfg0.num_nodes,
                               cfg0.num_supports, num_layers, output_dim,
                               cfg0.activation)
        sd = {f"{cell}.{k}": v for cell in ("layer0", "shared")
              for k, v in init.get(cell, {}).items()}
        sd.update({"proj.weight": init["proj_w"], "proj.bias": init["proj_b"]})
        self.load_state_dict(sd)

    def params(self) -> Dict[str, object]:
        out = {"layer0": self.layer0.params(), "proj_w": self.proj.weight,
               "proj_b": self.proj.bias}
        if hasattr(self, "shared"):
            out["shared"] = self.shared.params()
        return out


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
