"""Training epochs over a split held on the device: the program's
``--hbm_cache`` entry, ``train.step.make_cached_epoch_step`` over one
``TrainStep``.

Set-up makes the split on the device from the seed, builds the step with
the benchmark's weights, and drives it through its first three steps with
the window's own call (a plan of one batch, then of two, rows all
distinct), reading what the check compares: each step's loss, each
leaf's first gradient as Adam holds it after step 1, and each leaf's
change after step 3. A few more steps warm the card. The window then
runs whole epochs, each a fresh seeded shuffle uploaded once, the losses
read back once an epoch, as the program's trainer does.

Traffic parameters: ``rate_metric`` (the name of the rate the window
reports), ``batch``, ``split_clips`` (a multiple of the batch),
``positive_share`` (detection labels), ``warm_steps``, ``traced_epochs``
and ``detail_steps`` (the traced parts).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import inputs
from portbench.drivers.common import (
    leaf_gap,
    program_config,
    program_model,
    program_pipeline,
    reference_precision_flags,
    upload_plan,
)
from portbench.reference import dcrnn as ref
from portbench.reference import train as ref_train

SSL_TASK = "SS pre-training"
CHECK_STEPS = 3
# the readings come from set-up's first steps; the faults a training cell
# can have (portbench/faults.py)
READINGS_IN_WINDOW = False
FAULTS = ("unchanged_state", "half_batch")
# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone and are left out of the change's gap
ROUNDOFF_LEAF = 1e-3


class State:
    pass


def _torch_optimizer(opt):
    """The ``torch.optim.Optimizer`` of the program's optimizer."""
    if isinstance(opt, torch.optim.Optimizer):
        return opt
    for v in vars(opt).values():
        if isinstance(v, torch.optim.Optimizer):
            return v
    return None


def first_gradients(step) -> dict:
    """Each leaf's norm of the gradient Adam received at step 1 (after the
    clip and the L2 term): its first moment over (1 - beta1)."""
    opt = _torch_optimizer(step.optimizer)
    if opt is None:
        return {}
    out = {}
    for name, p in step.model.named_parameters():
        state = opt.state.get(p, {})
        if "exp_avg" not in state:
            continue
        beta1 = next(g["betas"][0] for g in opt.param_groups
                     if any(q is p for q in g["params"]))
        out[name] = float(state["exp_avg"].float().norm()) / (1.0 - beta1)
    return out


def _marker(dev):
    """Prints each part of the set-up's seconds to standard error."""
    last = [time.perf_counter()]

    def mark(what: str):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"set-up part: {what} {now - last[0]:.3f} s", file=sys.stderr)
        last[0] = now

    return mark


def setup(ctx) -> State:
    from eeg_gnn_tpu_torch.train.step import TrainStep, make_cached_epoch_step

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mark = _marker(dev)
    st = State()
    st.ctx = ctx
    st.ssl = cfg["task"] == SSL_TASK
    b, split = tr["batch"], tr["split_clips"]
    if split % b:
        raise ValueError(f"split_clips {split} is not a multiple of the "
                         f"batch {b}")
    st.batch, st.split = b, split
    st.steps_per_epoch = split // b
    exp = program_config(dict(cfg, train_batch_size=b))
    st.adj = inputs.distance_adjacency(cfg)
    mark("configuration")
    pipe = program_pipeline(ctx, exp, st.adj, augment=exp.data_augment)
    st.params0 = inputs.make_params(cfg, ctx.seed, dev)
    stats = ({"mean": cfg["feature_mean"], "std": cfg["feature_std"]}
             if st.ssl else {})
    st.step = TrainStep(exp, program_model(exp, st.params0),
                        steps_per_epoch=st.steps_per_epoch, device=dev,
                        generator=inputs.generator(ctx.seed, "step", dev),
                        input_pipeline=pipe, **stats)
    mark("weights, pipeline, the step built")
    gen = inputs.generator(ctx.seed, "split", dev)
    t, n, d = cfg["max_seq_len"], cfg["num_nodes"], cfg["input_dim"]
    st.x = inputs.features((split, t, n, d), cfg, gen, dev, False)
    if st.ssl:
        st.y = inputs.features((split, cfg["output_seq_len"], n,
                                cfg["output_dim"]), cfg, gen, dev, False)
    else:
        st.y = (torch.rand(split, generator=gen, device=dev)
                < tr["positive_share"]).float()
    st.run = make_cached_epoch_step(st.step, t, b)
    st.rng = inputs.host_rng(ctx.seed, "plan")
    st.seen0 = int(cfg.get("batches_seen_start", 0))
    st.seen = st.seen0
    st.valid_epoch = np.full(st.steps_per_epoch, b, np.int32)

    mark(f"the split made ({st.x.numel() * 4 / 1e9:.2f} GB of features)")
    perm = st.rng.permutation(split)
    losses = [st.run(st.x, st.y, upload_plan(perm[:b], dev),
                     np.full(1, b, np.int32), st.seen)]
    st.seen += b
    mark("step 1")
    grad1 = first_gradients(st.step)
    losses.append(st.run(st.x, st.y, upload_plan(perm[b:CHECK_STEPS * b],
                                                 dev),
                         np.full(CHECK_STEPS - 1, b, np.int32), st.seen))
    st.seen += (CHECK_STEPS - 1) * b
    change = {name: float((p.detach() - st.params0[name]).norm())
              for name, p in st.step.model.named_parameters()}
    st.readings = {"loss": torch.cat(losses).tolist(), "grad1": grad1,
                   "change": change}
    rows = torch.from_numpy(perm[:CHECK_STEPS * b].astype(np.int64)).to(dev)
    st.check_x = st.x.index_select(0, rows).clone()
    st.check_y = st.y.index_select(0, rows).clone()
    mark("steps 2-3")
    warm = tr["warm_steps"]
    lo = CHECK_STEPS * b
    if warm:
        st.run(st.x, st.y, upload_plan(perm[lo:lo + warm * b], dev),
               np.full(warm, b, np.int32), st.seen).sum().item()
        st.seen += warm * b
    mark(f"{warm} warm-up steps")
    return st


def _epoch(st, steps=None) -> torch.Tensor:
    """One plan: a whole epoch, or its first ``steps`` batches."""
    perm = st.rng.permutation(st.split)
    valid = st.valid_epoch
    if steps is not None:
        perm, valid = perm[:steps * st.batch], valid[:steps]
    losses = st.run(st.x, st.y, upload_plan(perm, st.ctx.device), valid,
                    st.seen)
    st.seen += int(valid.sum())
    return losses.cpu()


def window(st, seconds: float) -> dict:
    """Whole epochs until ``seconds`` have passed on the host clock; the
    rate is every clip trained over the whole time."""
    if st.ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = failed = 0
    ends = [t0]
    while True:
        losses = _epoch(st)
        steps += losses.numel()
        failed += int((~torch.isfinite(losses)).sum())
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    elapsed = ends[-1] - t0
    epochs = np.diff(ends)
    print(f"window: {len(epochs)} epochs, seconds each: "
          + " ".join(f"{e:.4f}" for e in epochs), file=sys.stderr)
    return {"metrics": {st.ctx.traffic["rate_metric"]:
                        steps * st.batch / elapsed},
            "attempted": steps, "failed": failed, "seconds": elapsed}


def traced(st, detail: bool) -> dict:
    """A traced part: ``traced_epochs`` more epochs, or with ``detail`` a
    plan of ``detail_steps`` batches."""
    if detail:
        return {"steps": _epoch(st, st.ctx.traffic["detail_steps"]).numel(),
                "batch": st.batch}
    steps = 0
    for _ in range(st.ctx.traffic["traced_epochs"]):
        steps += _epoch(st).numel()
    return {"steps": steps, "batch": st.batch}


def release(st):
    """Free the program and the split; keep what the check reads."""
    for name in ("step", "run", "x", "y"):
        setattr(st, name, None)
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference_batches(st) -> list:
    cfg, dev, b = st.ctx.cfg, st.ctx.device, st.batch
    mean, std = cfg["feature_mean"], cfg["feature_std"]
    gen = inputs.generator(st.ctx.seed, "step", dev) if st.ssl else None
    out = []
    for i in range(CHECK_STEPS):
        rows = slice(i * b, (i + 1) * b)
        batch = {"x": (st.check_x[rows] - mean) / std}
        if st.ssl:
            batch["y"] = (st.check_y[rows] - mean) / std
            batch["force"] = [False] * cfg["output_seq_len"]
            if cfg["use_curriculum_learning"]:
                # the step's generator draws one force vector a step
                ratio = ref_train.sampling_ratio(cfg["cl_decay_steps"],
                                                 st.seen0 + i * b)
                draws = torch.rand(cfg["output_seq_len"], generator=gen,
                                   device=dev)
                batch["force"] = (draws < ratio).tolist()
        else:
            batch["y"] = st.check_y[rows]
        out.append(batch)
    return out


def reference_readings(st, precision: str = "f32") -> dict:
    reference_precision_flags()
    cfg = st.ctx.cfg
    sup = torch.from_numpy(ref.supports(st.adj, "laplacian")).to(
        st.ctx.device)
    return ref_train.train_readings(cfg, st.params0, sup,
                                    _reference_batches(st),
                                    st.steps_per_epoch, precision)


def program_readings(st) -> dict:
    return st.readings


def compare(st, readings: dict) -> dict:
    """{number: value}: the worst step's relative loss gap, the worst
    leaf's gap of first-gradient norms, and the worst and the median
    leaf's gap of change norms after the steps, leaves moved by round-off
    left out. A cell compares those its limits name."""
    if not hasattr(st, "reference"):
        st.reference = reference_readings(st)
    r = st.reference
    lp, lr = readings.get("loss", []), r["loss"]
    loss_gap = (max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
                if len(lp) == len(lr) and all(a == a for a in lp)
                else float("inf"))
    raw = r["grad1_raw"]
    med = float(np.median(list(raw.values())))
    keep = [k for k, v in raw.items() if v >= ROUNDOFF_LEAF * med]
    return {"loss_gap": loss_gap,
            "grad1_gap": leaf_gap(readings.get("grad1"), r["grad1"]),
            "change_gap": leaf_gap(readings.get("change"), r["change"],
                                   keep),
            "change_gap_median": leaf_gap(readings.get("change"),
                                          r["change"], keep, median=True)}


def leaf_detail(st, readings: dict, worst: int = 3) -> dict:
    """The leaves with the widest gaps of first-gradient and change norms,
    with the reference's norms: for a look at what a number reads."""
    r = st.reference
    out = {}
    for key in ("grad1", "change"):
        prog = readings.get(key) or {}
        gaps = sorted(((abs(prog[n] - r[key][n]) / max(r[key][n], 1e-30), n)
                       for n in r[key] if n in prog), reverse=True)
        out[key] = [[n, g, r[key][n], r["grad1_raw"][n]]
                    for g, n in gaps[:worst]]
    return out
