"""The DCRNN models' work from a configuration's sizes: model FLOPs per
clip (for ``mfu``) and the DCGRU kernels' work items per train step or
forward chunk (for the ``roofline`` shares).

The configuration is the dict of ``portbench/configs/<name>.json``.
"""

from __future__ import annotations

from portbench.work import counts

SSL_TASK = "SS pre-training"


def shapes(cfg: dict) -> dict:
    """The sizes the counts read: nodes, units, operators M = S*K + 1
    (S = 1 for the combined graph's Laplacian, 2 for the individual
    graph's dual random walk), T, T_out and the stream's bytes."""
    s = 1 if cfg["graph_type"] == "combined" else 2
    return {"n": cfg["num_nodes"], "h": cfg["rnn_units"],
            "m": s * cfg["max_diffusion_step"] + 1,
            "t": cfg["max_seq_len"], "t_out": cfg["output_seq_len"],
            "stream_bytes": 2 if cfg["dtype"] == "bfloat16" else 4}


def _layer_dims(cfg: dict) -> list[int]:
    return [cfg["input_dim"]] + [cfg["rnn_units"]] * (
        cfg["num_rnn_layers"] - 1)


def fwd_flops_per_clip(cfg: dict) -> float:
    """Model FLOPs of one clip's forward: every encoder layer over T steps,
    the head (detection) or the decoder over T_out steps with its
    projection (SSL)."""
    sh = shapes(cfg)
    n, h, m = sh["n"], sh["h"], sh["m"]
    total = sum(sh["t"] * counts.cell_fwd_flops(n=n, h=h, d=d, m=m)
                for d in _layer_dims(cfg))
    if cfg["task"] == SSL_TASK:
        d_out = cfg["output_dim"]
        per_step = (counts.cell_fwd_flops(n=n, h=h, d=d_out, m=m)
                    + (cfg["num_rnn_layers"] - 1)
                    * counts.cell_fwd_flops(n=n, h=h, d=h, m=m)
                    + 2 * n * h * d_out)
        total += sh["t_out"] * per_step
    else:
        total += 2 * n * h * cfg["num_classes"]
    return float(total)


def train_flops_per_clip(cfg: dict) -> float:
    """Forward once, backward twice."""
    return 3.0 * fwd_flops_per_clip(cfg)


def dcgru_work(cfg: dict, b: int, train: bool) -> list:
    """The work items of the DCGRU kernels of one train step (``train``)
    or one forward over b clips: per encoder layer the bulk input
    projection and the state loop; in training the backward loop, the
    bulk dW and, for every layer but the first (fed data), the bulk dx;
    for SSL the decoder's forward, and in training its backward loop, its
    two dW products and dWp. The reductions of split partial slabs are
    scratch of the design and not counted."""
    sh = shapes(cfg)
    kw = dict(n=sh["n"], h=sh["h"], m=sh["m"], b=b,
              a_batch=1 if cfg["graph_type"] == "combined" else b,
              stream_bytes=sh["stream_bytes"])
    t = sh["t"]
    work = []
    for i, d in enumerate(_layer_dims(cfg)):
        work.append(counts.proj_work(t=t, d=d, **kw))
        work.append(counts.loop_work(t=t, **kw))
        if train:
            work.append(counts.bwd_loop_work(t=t, **kw))
            work.append(counts.dw_work(t=t, d=d, **kw))
            if i > 0:
                work.append(counts.dx_work(t=t, d=d, **kw))
    if cfg["task"] == SSL_TASK:
        t_out, d_out, layers = sh["t_out"], cfg["output_dim"], \
            cfg["num_rnn_layers"]
        work.append(counts.dec_work(t_out=t_out, d=d_out, layers=layers,
                                    **kw))
        if train:
            work.append(counts.dec_loop_work(t_out=t_out, d=d_out,
                                             layers=layers, **kw))
            work.append(counts.dw_work(t=t_out, d=d_out, **kw))
            if layers > 1:
                work.append(counts.dw_work(t=(layers - 1) * t_out,
                                           d=sh["h"], **kw))
            work.append(counts.dwp_work(t_out=t_out, n=sh["n"], h=sh["h"],
                                        d=d_out, b=b,
                                        stream_bytes=sh["stream_bytes"]))
    return work
