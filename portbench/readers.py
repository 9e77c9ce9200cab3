"""The arithmetic the per-layer readers (``portbench/metrics/<name>.py``)
share. Each takes the reader's context: ``trace`` (the steady traced
part, device activity alone), ``info`` (what that part ran: ``steps`` and
``batch``), ``detail`` and ``detail_info`` (the short
part with the host's operators), ``cfg``, ``rates`` (the window's
end-to-end values) and ``root``. Each returns None where it finds
nothing to read."""

from __future__ import annotations

import os

from portbench.trace import handwritten_kernels
from portbench.work.counts import bound_ms
from portbench.work.model import dcgru_work, train_flops_per_clip
from portbench.work.peaks import PEAK_F32_EXACT_TC

ADAM = "Optimizer.step#Adam.step"


def mfu(ctx, rate: str):
    """Model FLOPs trained a second (3 x forward) over the float32-exact
    tensor-core peak (3xTF32), in %."""
    r = ctx["rates"].get(rate)
    if r is None:
        return None
    return 100.0 * train_flops_per_clip(ctx["cfg"]) * r / PEAK_F32_EXACT_TC


def _handwritten_s(ctx) -> float:
    names = handwritten_kernels(os.path.join(ctx["root"], "eeg_gnn_tpu_torch",
                                             "csrc"))
    return ctx["trace"].handwritten_s(names)


def dcgru_roofline_train(ctx):
    """The least time of the traced steps' DCGRU work over the device time
    of the program's hand-written kernels, in %."""
    steps = ctx["info"].get("steps")
    spent = _handwritten_s(ctx) if steps else 0.0
    if spent <= 0:
        return None
    least_ms, _ = bound_ms(dcgru_work(ctx["cfg"], ctx["info"]["batch"],
                                      train=True))
    return 100.0 * least_ms * 1e-3 * steps / spent


def adam_ms_per_step(ctx):
    """Device ms under PyTorch's record of ``torch.optim.Adam``'s step
    (the L2 term and Adam; the program's clip runs before it, outside the
    record), per step of the part that records the host's operators."""
    steps = ctx["detail_info"].get("steps")
    spent = ctx["detail"].under_op_s(ADAM) if steps else 0.0
    if spent <= 0:
        return None
    return spent * 1e3 / steps


def launches_per_step(ctx):
    """Kernels the device ran per traced optimizer step (a count)."""
    steps = ctx["info"].get("steps")
    kernels = len(ctx["trace"].kernels())
    if not steps or not kernels:
        return None
    return kernels / steps


def device_idle_share(ctx):
    """1 - busy / window of the traced steps, in %."""
    tr = ctx["trace"]
    if not ctx["info"].get("steps") or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
