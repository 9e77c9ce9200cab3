"""What the drivers share: the run's context, the program's configuration
and input pipeline built from a benchmark configuration, and the
comparisons that decide ``correct``."""

from __future__ import annotations

import dataclasses
import statistics
import tempfile

import numpy as np
import torch

from portbench import inputs


@dataclasses.dataclass
class Context:
    cell: str
    cfg: dict          # portbench/configs/<config>.json
    traffic: dict      # portbench/traffic/<traffic>.json
    seed: int
    device: torch.device


def program_config(cfg: dict):
    """The program's ``ExperimentConfig`` of a benchmark configuration: its
    keys that are the program's flags, finalized."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return ExperimentConfig(**{k: v for k, v in cfg.items()
                               if k in names}).finalize()


def program_pipeline(ctx: Context, exp_cfg, adj, augment: bool):
    """The program's on-device input pipeline over the benchmark's graph
    and the configuration's feature statistics."""
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.scaler import StandardScaler

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        return make_device_pipeline(
            graph_type=exp_cfg.graph_type, filter_type=exp_cfg.filter_type,
            top_k=exp_cfg.top_k, use_fft=exp_cfg.use_fft,
            time_step_size=exp_cfg.time_step_size,
            scaler=StandardScaler(ctx.cfg["feature_mean"],
                                  ctx.cfg["feature_std"]),
            augment=augment, adj_mat_dir=inputs.adjacency_pickle(adj, tmp),
            num_nodes=exp_cfg.num_nodes, device=ctx.device)


def program_model(exp_cfg, params: dict):
    """The program's model holding the benchmark's weights."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    model = build_model(exp_cfg)
    model.load_state_dict(params)
    return model


def reference_precision_flags():
    """The reference computes float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def upload_plan(perm, device) -> torch.Tensor:
    """An epoch's row plan on the device, copied as the program's trainer
    copies it: one pinned, non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(perm, np.int64))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def leaf_gap(prog: dict, ref: dict, keep=None, median=False) -> float:
    """The worst leaf's gap of norms (with ``median``, the median leaf's),
    |prog - ref| over the larger of the reference's norm of that leaf and
    of the median leaf; a leaf the program does not report reads
    infinite."""
    keep = list(ref) if keep is None else list(keep)
    if not keep:
        return float("inf")
    med = statistics.median(ref[n] for n in keep)
    gaps = []
    for n in keep:
        p = prog.get(n) if prog else None
        if p is None or p != p:
            return float("inf")
        gaps.append(abs(p - ref[n]) / max(ref[n], med, 1e-30))
    return statistics.median(gaps) if median else max(gaps)
