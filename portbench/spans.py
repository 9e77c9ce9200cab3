"""The arithmetic of the per-layer readers of the program's own spans
(``eeg_gnn_tpu_torch/utils/profiling.py``): device time and kernels under
an ``eeg.step.*`` span per step of the traced part that records the
host's operators, and the program's set-up totals. Each returns None
where the program has no such span or total."""

from __future__ import annotations

import numpy as np

INPUT = "eeg.step.input"
UPDATE = "eeg.step.update"
STEP_BUILD = "eeg.setup.train_step"


def correlations(tr, span: str) -> set:
    """The correlation ids of the runtime calls made on a span's thread
    inside it (``Trace.under_op_s``'s rule)."""
    spans = [e for e in tr.host if e.get("name") == span]
    if not spans:
        return set()
    rt = [e for e in tr.host if e["cat"] in ("cuda_runtime", "cuda_driver")]
    ts = np.array([e["ts"] for e in rt], dtype=np.float64)
    tid = np.array([hash(e.get("tid")) for e in rt], dtype=np.int64)
    corr = np.array([e.get("args", {}).get("correlation", -1) for e in rt],
                    dtype=np.int64)
    ids = set()
    for s in spans:
        sel = ((ts >= s["ts"]) & (ts <= s["ts"] + s["dur"])
               & (tid == hash(s.get("tid"))))
        ids.update(int(c) for c in corr[sel] if c >= 0)
    return ids


def device_ms_per_step(ctx, span: str):
    """Device ms of the work launched inside ``span`` per step."""
    steps = ctx["detail_info"].get("steps")
    spent = ctx["detail"].under_op_s(span) if steps else 0.0
    if spent <= 0:
        return None
    return spent * 1e3 / steps


def launches_per_step(ctx, span: str):
    """Kernels launched inside ``span`` per step (a count)."""
    steps = ctx["detail_info"].get("steps")
    ids = correlations(ctx["detail"], span) if steps else set()
    n = sum(1 for e in ctx["detail"].kernels()
            if e.get("args", {}).get("correlation") in ids)
    if not n:
        return None
    return n / steps


def setup_seconds(name: str):
    """Host seconds of the program's timed set-up part ``name`` in this
    process."""
    try:
        from eeg_gnn_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    total = totals().get(name)
    return None if total is None else total.seconds
