"""A plain float32 DCRNN in PyTorch: the benchmark's reference.

It follows the published model (Tang et al., ICLR 2022,
github.com/tsy935/eeg-gnn-ssl: ``model/cell.py``, ``model/model.py``,
``utils.py``) step by step, with no kernel, cache or batching trick:

- supports from the adjacency in float64 NumPy: the Chebyshev-scaled
  Laplacian (2/lambda_max) L - I of the symmetrised graph (``laplacian``,
  the combined graph's) or the two transposed random walks
  (``dual_random_walk``, the individual graph's);
- the diffusion stack [x, S x, 2 S^2 x - x, ...] per support, with the
  published carry-over between supports, flattened feature-major
  (weight row ``d*M + m``);
- the DCGRU cell: ru = sigmoid([x | h] -> gate), c = tanh([x | r*h] ->
  cand), h' = u*h + (1-u)*c;
- the detector: the encoder's top layer at the last step, ReLU, a
  per-node linear layer, the max over nodes; BCE on the logits;
- the SSL model: the encoder's last states start a decoder whose first
  layer reads the output width and whose later layers share one cell, a
  projection, and the ground truth fed back where the force vector says;
  the masked RMSE of inverse-standardized values (the published training
  loss, selected by its 'MAE' flag).

``precision="tf32"`` computes every product with its operands rounded to
TF32 (10 mantissa bits, float32 sums), forward and backward: the
reference one precision below float32, the control of the comparisons.

It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties to even,
    still stored as float32."""
    i = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and so in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ra, rb, rg = tf32_round(a), tf32_round(b), tf32_round(g)
        ga = torch.matmul(rg, rb.transpose(-1, -2)).sum_to_size(a.shape)
        gb = torch.matmul(ra.transpose(-1, -2), rg).sum_to_size(b.shape)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32"):
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


# --------------------------------------------------------------------------
# supports
# --------------------------------------------------------------------------


def scaled_laplacian(adj: np.ndarray) -> np.ndarray:
    """(2/lambda_max) L - I of max(A, A^T), L = I - D^-1/2 A^T D^-1/2."""
    a = np.asarray(adj, np.float64)
    a = np.maximum(a, a.T)
    d = a.sum(axis=1)
    with np.errstate(divide="ignore"):
        dis = np.where(d > 0, d ** -0.5, 0.0)
    n = a.shape[0]
    lap = np.eye(n) - (a * dis[None, :]).T * dis[None, :]
    lam = float(np.linalg.eigvalsh((lap + lap.T) / 2.0)[-1])
    return (2.0 / lam) * lap - np.eye(n)


def random_walk(adj: np.ndarray) -> np.ndarray:
    """D^-1 A, rows of zero degree left zero."""
    a = np.asarray(adj, np.float64)
    d = a.sum(axis=1)
    with np.errstate(divide="ignore"):
        inv = np.where(d > 0, 1.0 / d, 0.0)
    return inv[:, None] * a


def supports(adj: np.ndarray, filter_type: str) -> np.ndarray:
    """(S, N, N) float32 supports of one adjacency."""
    if filter_type == "laplacian":
        sup = [scaled_laplacian(adj)]
    elif filter_type == "dual_random_walk":
        sup = [random_walk(adj).T, random_walk(np.asarray(adj).T).T]
    else:
        raise ValueError(f"unknown filter {filter_type!r}")
    return np.stack(sup).astype(np.float32)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def diffusion_features(sup: torch.Tensor, x: torch.Tensor, k: int,
                       precision: str) -> torch.Tensor:
    """(..., N, D) -> (..., N, D*M) in the published order and layout."""
    feats = [x]
    x0, x1 = x, None
    for s in sup:
        x1 = matmul(s, x0, precision)
        feats.append(x1)
        for _ in range(2, k + 1):
            x2 = 2.0 * matmul(s, x1, precision) - x0
            feats.append(x2)
            x1, x0 = x2, x1
    stacked = torch.stack(feats, dim=-1)
    return stacked.reshape(*stacked.shape[:-2], -1)


def cell(p: dict, sup, x, h, k: int, precision: str) -> torch.Tensor:
    """One DCGRU step: p holds gate_w, gate_b, cand_w, cand_b."""
    units = h.shape[-1]
    f = diffusion_features(sup, torch.cat([x, h], -1), k, precision)
    ru = torch.sigmoid(matmul(f, p["gate_w"], precision) + p["gate_b"])
    r, u = ru[..., :units], ru[..., units:]
    f = diffusion_features(sup, torch.cat([x, r * h], -1), k, precision)
    c = torch.tanh(matmul(f, p["cand_w"], precision) + p["cand_b"])
    return u * h + (1.0 - u) * c


def _cell_params(params: dict, prefix: str) -> dict:
    return {k: params[f"{prefix}.{k}"]
            for k in ("gate_w", "gate_b", "cand_w", "cand_b")}


def encoder(params: dict, sup, x, layers: int, k: int, precision: str):
    """x (B, T, N, D) -> (last states [L x (B, N, H)], top layer's last
    state)."""
    b, t, n, _ = x.shape
    units = params["encoder.0.gate_b"].shape[0] // 2
    seq = [x[:, i] for i in range(t)]
    lasts = []
    for layer in range(layers):
        p = _cell_params(params, f"encoder.{layer}")
        h = x.new_zeros((b, n, units))
        out = []
        for xt in seq:
            h = cell(p, sup, xt, h, k, precision)
            out.append(h)
        seq = out
        lasts.append(h)
    return lasts


def detector_logits(params: dict, sup, x, layers: int, k: int,
                    precision: str = "f32") -> torch.Tensor:
    """(B,) logits of full-length clips x (B, T, N, D)."""
    last = encoder(params, sup, x, layers, k, precision)[-1]
    hid = torch.relu(last)
    out = matmul(hid, params["fc.weight"].t(), precision) + params["fc.bias"]
    return out.amax(dim=1).reshape(-1)


def ssl_predictions(params: dict, sup, x, y, force, layers: int, k: int,
                    precision: str = "f32") -> torch.Tensor:
    """(B, T_out, N, D_out) predictions of the next windows y (B, T_out,
    N, D_out) from x, feeding back y[:, t] after step t where force[t]."""
    h = encoder(params, sup, x, layers, k, precision)
    cells = [_cell_params(params, "decoder.layer0")]
    cells += [_cell_params(params, "decoder.shared")] * (layers - 1)
    cur = y.new_zeros(y[:, 0].shape)
    outs = []
    for t in range(y.shape[1]):
        inp = cur
        for i, p in enumerate(cells):
            h[i] = cell(p, sup, inp, h[i], k, precision)
            inp = h[i]
        proj = (matmul(inp, params["decoder.proj.weight"].t(), precision)
                + params["decoder.proj.bias"])
        outs.append(proj)
        cur = y[:, t] if bool(force[t]) else proj
    return torch.stack(outs, dim=1)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype))


def masked_rmse(pred, true, mean: float, std: float) -> torch.Tensor:
    """The published SSL training loss: both inverse-standardized, entries
    where the truth is 0 masked, the mask normalized by its mean, NaN to 0,
    the square root of the mean square."""
    pred = pred * std + mean
    true = true * std + mean
    mask = (true != 0.0).to(pred.dtype)
    mask = mask / mask.mean()
    err = (pred - true) ** 2 * mask
    err = torch.where(torch.isnan(err), torch.zeros_like(err), err)
    return torch.sqrt(err.mean())
