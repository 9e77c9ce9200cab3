"""Operations and bytes of the DCGRU kernels' work, from shapes alone.

Each function gives one kernel launch's work as a tuple, (FMA FLOPs,
bytes) or (FMA FLOPs, bytes, tensor-core FLOPs, their rate): the identity
operator A_0 is skipped, every input byte is read once and every output
byte written once, and scratch of a design (split partial slabs) is not
counted. ``bound_ms`` turns a list of them into the least time the chip
could take. The shapes are explicit: t steps, n nodes, h units, m
operators (M = S*K + 1), b clips, ``a_batch`` the operator stack's batch
(1 for a graph shared by all clips).
"""

from __future__ import annotations

from portbench.work.peaks import (
    PEAK_BF16_TC,
    PEAK_BYTES,
    PEAK_F32_FLOPS,
    PEAK_F32_EXACT_TC,
)


def _tc(flops: float, stream_bytes: int) -> tuple[float, float]:
    """Products at the tensor-core rate for the stream dtype: bf16 for bf16
    streams; for f32 the exact-f32 3xTF32 rate (a third of TF32's)."""
    if stream_bytes == 2:
        return float(flops), PEAK_BF16_TC
    return float(flops), PEAK_F32_EXACT_TC


def dw_size(m: int, d: int, h: int) -> int:
    """Floats of one layer's dW and db: [dWx (M*D, 3H) | dWh (M*H, 3H) |
    db (3H)]; d = 0 for a layer fed a hoisted projection."""
    return (m * d + m * h) * 3 * h + 3 * h


def proj_work(*, t: int, n: int, h: int, d: int, m: int, b: int,
              a_batch: int, stream_bytes: int) -> tuple:
    """One bulk input projection over all t steps: the diffusions A_m x and
    the (M*D, 3H) product at the tensor-core rate; x, Wx and the operators
    read once, the f32 projection written once."""
    rows = t * b * n
    diff = 2 * (m - 1) * n * n * d * t * b
    nbytes = (rows * d * stream_bytes + m * d * 3 * h * 4
              + m * a_batch * n * n * 4 + rows * 3 * h * 4)
    return (0.0, float(nbytes),
            *_tc(diff + 2 * rows * m * d * 3 * h, stream_bytes))


def loop_work(*, t: int, n: int, h: int, m: int, b: int, a_batch: int,
              stream_bytes: int, xp_bytes: int = 4) -> tuple:
    """One forward state loop fed a projection of ``xp_bytes`` elements:
    per step and clip the hidden diffusions of h and r*h and the hidden
    rows' products (gate and candidate) at the tensor-core rate; hidden
    weights, biases, the projection, the operators and h0 read once,
    h_seq written once."""
    diff_h = 2 * (m - 1) * n * n * h
    gemm_h = 2 * n * (m * h) * 3 * h
    per_step = 2 * diff_h + gemm_h
    nbytes = (m * h * 3 * h + 3 * h) * 4
    nbytes += t * b * n * 3 * h * xp_bytes
    nbytes += m * a_batch * n * n * 4 + b * n * h * 4
    nbytes += t * b * n * h * stream_bytes
    return (0.0, float(nbytes), *_tc(per_step * t * b, stream_bytes))


def bwd_loop_work(*, t: int, n: int, h: int, m: int, b: int, a_batch: int,
                  stream_bytes: int) -> tuple:
    """The state-only backward loop: per step and clip the weight-transpose
    products dpre W_h^T and two A^T applies at the tensor-core rate;
    h_prev, ru, c, d_seq read once, dpre (f32) and dh0 written once."""
    per_step = 2 * n * 3 * h * m * h + 4 * (m - 1) * n * n * h
    nbytes = m * h * 3 * h * 4 + t * b * n * 5 * h * stream_bytes
    nbytes += t * b * n * 3 * h * 4 + m * a_batch * n * n * 4 + b * n * h * 4
    return (0.0, float(nbytes), *_tc(per_step * t * b, stream_bytes))


def dw_work(*, t: int, n: int, h: int, d: int, m: int, b: int, a_batch: int,
            stream_bytes: int) -> tuple:
    """One bulk dW product over t steps: the features A_m [x | h_prev |
    r h_prev] and the three products at the tensor-core rate, db's sums on
    FMA; x, h_prev, r, dpre and the operators read once, dW and db written
    once."""
    rows = t * b * n
    diff = 2 * (m - 1) * n * n * (d + 2 * h) * t * b
    nbytes = rows * (d + 2 * h) * stream_bytes + rows * 3 * h * 4
    nbytes += m * a_batch * n * n * 4 + dw_size(m, d, h) * 4
    tc = diff + 2 * rows * (m * d * 3 * h + m * h * 2 * h + m * h * h)
    return (float(rows * 3 * h), float(nbytes), *_tc(tc, stream_bytes))


def dx_work(*, t: int, n: int, h: int, d: int, m: int, b: int, a_batch: int,
            stream_bytes: int) -> tuple:
    """One bulk dx product: A_m^T dpre and the (3H, M*D) product at the
    tensor-core rate; dpre, Wx and the operators read once, dx written
    once."""
    rows = t * b * n
    diff = 2 * (m - 1) * n * n * 3 * h * t * b
    nbytes = (rows * 3 * h * 4 + m * d * 3 * h * 4
              + m * a_batch * n * n * 4 + rows * d * stream_bytes)
    return (0.0, float(nbytes),
            *_tc(diff + 2 * rows * 3 * h * m * d, stream_bytes))


def cell_fwd_flops(*, n: int, h: int, d: int, m: int) -> int:
    """FLOPs of one DCGRU cell step of one clip at input width d (A_0 = I
    skipped): the diffusions of [x | h] and of r*h, and the gate and
    candidate products."""
    return 2 * (m - 1) * n * n * (2 * h + d) + 2 * n * (m * d + m * h) * 3 * h


def _dec_weights(*, h: int, d: int, m: int, layers: int) -> int:
    """Floats of the decoder's weights and biases (layer 0, the shared
    cell, the projection)."""
    cell = lambda din: m * (din + h) * 3 * h + 3 * h
    return cell(d) + (cell(h) if layers > 1 else 0) + h * d + d


def dec_work(*, t_out: int, n: int, h: int, d: int, m: int, layers: int,
             b: int, a_batch: int, stream_bytes: int) -> tuple:
    """One decoder forward launch: per clip-step each layer's cell (layer 0
    at width d, the rest at h) and the projection, at the tensor-core
    rate; x, the operators, h0 and the weights read once, the projection
    and the residuals (in0, h, ru, c) written once."""
    per_step = (cell_fwd_flops(n=n, h=h, d=d, m=m)
                + (layers - 1) * cell_fwd_flops(n=n, h=h, d=h, m=m)
                + 2 * n * h * d)
    nbytes = _dec_weights(h=h, d=d, m=m, layers=layers) * 4 + t_out * 4
    nbytes += m * a_batch * n * n * 4 + layers * b * n * h * 4
    nbytes += t_out * b * n * (3 * d + 4 * layers * h) * stream_bytes
    return (0.0, float(nbytes), *_tc(per_step * t_out * b, stream_bytes))


def dec_loop_work(*, t_out: int, n: int, h: int, d: int, m: int,
                  layers: int, b: int, a_batch: int,
                  stream_bytes: int) -> tuple:
    """The decoder's backward state loop: per clip-step dproj Wp^T and per
    layer dpre W^T and the A^T applies, at the tensor-core rate; h_prev,
    ru, c, d_seq read once, dx, dpre, dproj and dh0 written once."""
    def cell(din):
        return (2 * n * 3 * h * m * (h + din)
                + 2 * (m - 1) * n * n * (2 * h + din))
    per_step = cell(d) + (layers - 1) * cell(h) + 2 * n * d * h
    weights = m * (d + h) * 3 * h + h * d
    weights += m * 2 * h * 3 * h if layers > 1 else 0
    nbytes = weights * 4 + t_out * 4
    nbytes += m * a_batch * n * n * 4 + layers * b * n * h * 4
    rows = t_out * b * n
    nbytes += rows * (4 * layers * h + 2 * d) * stream_bytes
    nbytes += rows * (3 * layers * h + d) * 4
    return (0.0, float(nbytes), *_tc(per_step * t_out * b, stream_bytes))


def dwp_work(*, t_out: int, n: int, h: int, d: int, b: int,
             stream_bytes: int) -> tuple:
    """dWp = h_top^T dproj over t_out*b*n rows: the product at the
    tensor-core rate, dbp's sums on FMA; h_top and dproj read once, dWp
    and dbp written once."""
    rows = t_out * b * n
    return (float(rows * d),
            float(rows * (h * stream_bytes + d * 4) + (h * d + d) * 4),
            *_tc(2 * rows * h * d, stream_bytes))


def reduce_work(b: int, w: int) -> tuple[float, float]:
    """(FLOPs, bytes) of summing a (b, w) f32 slab over b."""
    return float(b * w), float((b * w + w) * 4)


def bound_ms(work) -> tuple[float, str]:
    """The least time for the work items: in each item FMA at the
    non-tensor f32 rate and tensor-core products at theirs, which overlap
    (the larger of the two); bytes at the HBM rate; the larger of
    operations and bytes over all items. Returns (ms, which bounds it)."""
    t_ops = sum(max(w[0] / PEAK_F32_FLOPS, w[2] / w[3] if len(w) > 2 else 0)
                for w in work)
    t_bytes = sum(w[1] for w in work) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
