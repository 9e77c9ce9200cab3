#!/usr/bin/env python3
"""Serving A/B on one CUDA card: ``Predictor`` batches of several checkouts
of this repository, timed in turns, each turn in a process of its own.

    python3 serve_ab.py PARENT_CHECKOUT . . PARENT_CHECKOUT

Each argument is a checkout's root; the turns run in the order given (for
two versions: parent, change, change, parent). A turn builds its
checkout's CUDA sources (content-addressed, so a later turn of the same
checkout loads them), then times, at the flagship detector's shapes (2
DCGRU layers x 64 units, K=2, input_dim 100, T=60, batch 128, weights from
a seeded ``torch.Generator``, per-clip adjacency):

- ``Predictor.predict_proba`` (host numpy in, probabilities out): the
  kernel path (``input_fusion``) combined bfloat16 and float32 and
  individual bfloat16; the ``use_pallas`` path combined bfloat16 and
  float32;
- the model's forward alone on device tensors, for the kernel-path cases;
- the host-to-device copy of one batch's x (58 MB float32), from pageable
  and from pinned host memory;
- one traced ``predict_proba`` call of each kernel-path case
  (torch.profiler): its wall time, the device's busy time, and the device
  time and host self time of its heaviest operations.

Each time is the median of ``REPS`` calls after 3 warm-up calls (CUDA
events around the call). One line per measurement and turn; the last line
is a JSON object with every turn's numbers.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPS = 20
T, N, H, K, D, BATCH = 60, 19, 64, 2, 100, 128
CASES = (  # (label, graph type, dtype, use_pallas)
    ("kernels combined bf16", "combined", "bfloat16", False),
    ("kernels combined f32", "combined", "float32", False),
    ("kernels individual bf16", "individual", "bfloat16", False),
    ("use_pallas combined bf16", "combined", "bfloat16", True),
    ("use_pallas combined f32", "combined", "float32", True),
)


def time_ms(torch, fn, reps=REPS, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace(torch, fn, rows=6) -> dict:
    """One traced call of ``fn``: wall ms (host clock, synchronised), the
    device's busy ms, and the heaviest operations by device time and by
    host self time."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.key.startswith("Activity Buffer") \
                    and e.self_device_time_total > 0:
                dev.append((e.self_device_time_total / 1e3, e.key[:60]))
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / 1e3, e.key[:60]))
    dev.sort(reverse=True)
    host.sort(reverse=True)
    return {"wall": wall, "device busy": sum(d[0] for d in dev),
            "device": dev[:rows], "host self": host[:rows]}


def worker(root: str) -> dict:
    """One turn: the measurements of the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import eeg_gnn_tpu_torch
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import _build
    from eeg_gnn_tpu_torch.serve import Predictor

    if not eeg_gnn_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {eeg_gnn_tpu_torch.__file__}, not the "
                           f"package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                   if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        list(pool.map(_build.build, names))

    rng = np.random.RandomState(3)
    x = rng.randn(BATCH, T, N, D).astype(np.float32)
    lens = np.full((BATCH,), T, np.int64)
    adj = np.abs(rng.rand(BATCH, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    dev = torch.device("cuda")
    out = {"root": root}
    for label, gt, dtype, pallas in CASES:
        cfg = ExperimentConfig(graph_type=gt, dtype=dtype, input_fusion=True,
                               use_pallas=pallas, max_seq_len=T,
                               num_rnn_layers=2, rnn_units=H,
                               max_diffusion_step=K, input_dim=D,
                               test_batch_size=BATCH).finalize()
        pred = Predictor(cfg, build_model(
            cfg, torch.Generator().manual_seed(11)).state_dict())
        run = lambda: pred.predict_proba(x, lens, adjacency=adj)
        out[f"Predictor {label}"] = time_ms(torch, run)
        if not pallas:
            out[f"trace {label}"] = trace(torch, run)
            xd = torch.from_numpy(x).to(dev)
            ld = torch.from_numpy(lens).to(dev)
            sd = compute_supports_torch(torch.from_numpy(adj).to(dev),
                                        cfg.filter_type)

            def forward():
                with torch.inference_mode():
                    pred.model(xd, ld, sd)

            out[f"forward {label}"] = time_ms(torch, forward)
    xt = torch.from_numpy(x)
    pinned = xt.pin_memory()
    out["H2D x pageable"] = time_ms(torch, lambda: xt.to(dev))
    out["H2D x pinned"] = time_ms(
        torch, lambda: pinned.to(dev, non_blocking=True))
    return out


def main(roots):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        sys.exit(f"serve_ab: nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"serve_ab: turn {i} ({root}) failed:\n{proc.stderr}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(turn)
        for key, ms in turn.items():
            if key.startswith("trace"):
                print(f"turn {i} {root}: {key}: wall {ms['wall']:.3f} ms, "
                      f"device busy {ms['device busy']:.3f} ms", flush=True)
                for side in ("device", "host self"):
                    for t, op in ms[side]:
                        print(f"turn {i}   {side} {t:8.3f} ms  {op}",
                              flush=True)
            elif key != "root":
                print(f"turn {i} {root}: {key} {ms:.3f} ms", flush=True)
    print(json.dumps({"card": card, "reps": REPS, "turns": turns}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2])), flush=True)
    elif len(sys.argv) > 1 and not {"-h", "--help"} & set(sys.argv):
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
