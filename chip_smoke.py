#!/usr/bin/env python3
"""Smoke test of eeg_gnn_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. print the card's name and power limit; turn TF32 off; build the CUDA
   kernels from ``eeg_gnn_tpu_torch/csrc`` with nvcc;
2. hold every kernel against its plain PyTorch version on the card at
   T=60, N=19, H=64 (D=100 and 64; M=3 per-clip, M=3 shared, M=5
   per-clip; B=128 and 37; float32 and bfloat16; the ru/c residuals in
   one case each), by the normalized inf-norm error max|k-p| / max|p|:
   float32 <= 1e-4 (the same f32 arithmetic summed in another order),
   bfloat16 <= 2e-2 (the bf16 bound of benchmarks/tpu_kernel_parity.json);
3. serve the flagship DCRNN detector (2 DCGRU layers x 64 units, K=2,
   input_dim 100, T=60, batch 128, random weights from a seeded
   torch.Generator) through ``Predictor`` for both graph types, float32
   and bfloat16 and both ``input_fusion`` settings: every batch must
   launch its kernel once per layer, and the probabilities must be finite,
   in [0, 1], and match an all-plain forward on the card (float32 atol
   1e-4, bfloat16 atol 2e-2) and, on a small input, the CPU;
4. time each kernel (per layer, B=128, M=3) and its plain version with
   CUDA events (median of 20 runs after warm-up) and the Predictor's
   clips/s.

The second-to-last line is a JSON object describing the kernels; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

T, N, H, K = 60, 19, 64, 2
BATCH = 128
F32_TOL, BF16_TOL = 1e-4, 2e-2
PEAK_F32_FLOPS = 67e12   # H100 SXM, non-tensor float32 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
REPS = 20


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def adjacency(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Random symmetric adjacency with unit diagonal (bench.py:34-43)."""
    adj = np.abs(rng.rand(n, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    return adj


def layer_inputs(torch, dev, *, d, m, shared, b, dtype, seed):
    """Operators, weights and streams of one DCGRU layer, as the model's
    ``_layer_scan`` hands them to the kernels."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcgru import DCGRUConfig, init_dcgru_cell
    from eeg_gnn_tpu_torch.ops.recurrent import (
        chebyshev_operators,
        rearrange_hidden_weight,
    )

    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    filt = "laplacian" if m == 3 else "dual_random_walk"
    adj = torch.from_numpy(adjacency(rng, 1 if shared else b)).to(dev)
    a_ops = chebyshev_operators(compute_supports_torch(adj, filt), K)
    a_ops = a_ops.contiguous()
    cfg = DCGRUConfig(d, H, K, N, (m - 1) // K)
    p = {k: v.to(dev) for k, v in init_dcgru_cell(gen, cfg).items()}
    p["gate_b"] = 0.1 * torch.randn(2 * H, generator=gen).to(dev)
    p["cand_b"] = 0.1 * torch.randn(H, generator=gen).to(dev)
    cut = d * m
    wx_g, wx_c = p["gate_w"][:cut], p["cand_w"][:cut]
    mmajor = lambda w: w.reshape(d, m, -1).transpose(0, 1).reshape(
        m * d, -1).contiguous()
    x = torch.randn((T, b, N, d), generator=gen).to(dev, dtype)
    x_proj = (0.5 * torch.randn((T, b, N, 3 * H), generator=gen)).to(
        dev, dtype)
    return {
        "x": x, "x_proj": x_proj, "a_ops": a_ops,
        "wxg_f": mmajor(wx_g), "wxc_f": mmajor(wx_c),
        "wg_r": rearrange_hidden_weight(p["gate_w"][cut:], H, m).contiguous(),
        "wc_r": rearrange_hidden_weight(p["cand_w"][cut:], H, m).contiguous(),
        "gate_b": p["gate_b"], "cand_b": p["cand_b"],
        "h0": (0.1 * torch.randn((b, N, H), generator=gen)).to(dev),
    }


def xin_args(a):
    return (a["x"], a["a_ops"], a["wxg_f"], a["wxc_f"], a["wg_r"], a["wc_r"],
            a["gate_b"], a["cand_b"], a["h0"])


def hoisted_args(a):
    return (a["x_proj"], a["a_ops"], a["wg_r"], a["wc_r"], a["gate_b"],
            a["cand_b"], a["h0"])


def norm_err(k, p) -> tuple[float, float]:
    """(normalized inf-norm error, max abs error) of kernel vs plain."""
    k, p = k.float(), p.float()
    max_abs = float((k - p).abs().max())
    return max_abs / max(float(p.abs().max()), 1e-12), max_abs


# ---------------------------------------------------------------------------
# counts for the bound
# ---------------------------------------------------------------------------


def layer_work(*, xin: bool, d: int, m: int, b: int, a_batch: int,
               stream_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) one kernel launch needs: the identity operator A_0 is
    skipped, each input is read once and each output written once."""
    diff_h = 2 * (m - 1) * N * N * H           # A_m h and A_m (r*h)
    gemm_h = 2 * N * (m * H) * 3 * H           # hidden rows, gate + cand
    per_step = 2 * diff_h + gemm_h
    nbytes = (m * H * 3 * H + 3 * H) * 4       # hidden weights + biases
    if xin:
        per_step += 2 * (m - 1) * N * N * d    # A_m x
        per_step += 2 * N * (m * d) * 3 * H    # input rows, gate + cand
        nbytes += m * d * 3 * H * 4 + T * b * N * d * stream_bytes
    else:
        nbytes += T * b * N * 3 * H * stream_bytes
    nbytes += m * a_batch * N * N * 4 + b * N * H * 4      # a_ops, h0
    nbytes += T * b * N * H * stream_bytes                 # h_seq
    return float(per_step) * T * b, float(nbytes)


def bound_ms(work) -> tuple[float, str]:
    flops = sum(w[0] for w in work)
    nbytes = sum(w[1] for w in work)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps=REPS, warmup=3, lead=True) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events). With
    ``lead`` the stream first sleeps ~1 ms so the host's enqueue cost does
    not show as device idle inside the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)  # name, power limit: as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from eeg_gnn_tpu_torch.ops import _build
    from eeg_gnn_tpu_torch.ops import cuda_recurrent

    path, secs, report = _build.build("dcgru_recurrence")
    log(f"build: dcgru_recurrence.cu -> {path} in {secs:.1f} s")
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            log(f"  ptxas: {line.strip()}")
    cuda_recurrent._lib()
    return card


def phase_parity(torch, dev):
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    worst = {"dcgru_recurrence_xin_fwd": 0.0, "dcgru_recurrence_fwd": 0.0}
    main_abs = {"dcgru_recurrence_xin_fwd": 0.0, "dcgru_recurrence_fwd": 0.0}
    ops_cases = [(3, False), (3, True), (5, False)]
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        for m, shared in ops_cases:
            for b in (BATCH, 37):
                # the hoisted kernel's input is x_proj (3H wide) whatever
                # D is, so it runs once per case, beside D=100
                for d in (100, 64):
                    seed += 1
                    a = layer_inputs(torch, dev, d=d, m=m, shared=shared,
                                     b=b, dtype=dtype, seed=seed)
                    residuals = (b == BATCH and d == 100 and m == 3
                                 and not shared and dtype == torch.float32)
                    runs = [("dcgru_recurrence_xin_fwd", cr.dcgru_recurrence_xin_fwd,
                             cr.dcgru_recurrence_xin_fwd_plain, xin_args(a))]
                    if d == 100:
                        runs.append(("dcgru_recurrence_fwd", cr.dcgru_recurrence_fwd,
                                     cr.dcgru_recurrence_fwd_plain,
                                     hoisted_args(a)))
                    for name, kern, plain, args in runs:
                        got = kern(*args, residuals=residuals)
                        torch.cuda.synchronize()
                        want = plain(*args, residuals=residuals)
                        outs = ("h_seq", "ru_seq", "c_seq") if residuals \
                            else ("h_seq",)
                        for i, out in enumerate(outs):
                            err, max_abs = norm_err(got[i], want[i])
                            if not np.isfinite(err) or err > tol:
                                fail(f"{name} {out} D={d} M={m} shared="
                                     f"{shared} B={b} {dtype}: normalized "
                                     f"error {err:.3e} > {tol:.0e}")
                            worst[name] = max(worst[name], err)
                            if (b == BATCH and m == 3 and not shared
                                    and dtype == torch.bfloat16):
                                main_abs[name] = max(main_abs[name], max_abs)
                            log(f"parity {name} {out} D={d} M={m} "
                                f"{'shared' if shared else 'per-clip'} B={b} "
                                f"{str(dtype)[6:]}: norm err {err:.3e} "
                                f"(max abs {max_abs:.3e}, tol {tol:.0e})")
    return worst, main_abs


def flagship_cfg(graph_type, dtype, input_fusion):
    from eeg_gnn_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(graph_type=graph_type, dtype=dtype,
                            input_fusion=input_fusion, max_seq_len=T,
                            num_rnn_layers=2, rnn_units=H,
                            max_diffusion_step=K, input_dim=100,
                            test_batch_size=BATCH).finalize()


def phase_serve(torch):
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
    from eeg_gnn_tpu_torch.serve import Predictor

    rng = np.random.RandomState(7)
    requests = []
    for n in (BATCH, 37):  # one full batch, one padded partial batch
        requests.append((rng.randn(n, T, N, 100).astype(np.float32),
                         rng.randint(T // 2, T + 1, size=n),
                         adjacency(rng, n)))
    batches = sum(-(-len(r[0]) // BATCH) for r in requests)
    kernels = {True: cr.dcgru_recurrence_xin_fwd, False: cr.dcgru_recurrence_fwd}
    # the main path's run: counts start at 0 here and are read at the end
    cr.dcgru_recurrence_xin_fwd.launches = 0
    cr.dcgru_recurrence_fwd.launches = 0
    checked_cpu = False
    for gt in ("combined", "individual"):
        for dtype in ("float32", "bfloat16"):
            for fusion in (True, False):
                cfg = flagship_cfg(gt, dtype, fusion)
                params = build_model(
                    cfg, torch.Generator().manual_seed(11)).state_dict()
                pred = Predictor(cfg, params)
                plain = Predictor(dataclasses.replace(cfg, recurrence="stacked"),
                                  params)
                before = {f: k.launches for f, k in kernels.items()}
                probs = [pred.predict_proba(x, lens, adjacency=adj)
                         for x, lens, adj in requests]
                rose = {f: k.launches - before[f] for f, k in kernels.items()}
                if rose[fusion] != 2 * batches or rose[not fusion] != 0:
                    fail(f"{gt} {dtype} fusion={fusion}: launches rose by "
                         f"{rose}, want {2 * batches} of the "
                         f"{kernels[fusion].__name__} kernel only")
                tol = F32_TOL if dtype == "float32" else BF16_TOL
                diff = 0.0
                for (x, lens, adj), p in zip(requests, probs):
                    if p.shape != (len(x),) or not np.all(np.isfinite(p)) \
                            or p.min() < 0 or p.max() > 1:
                        fail(f"{gt} {dtype} fusion={fusion}: bad "
                             f"probabilities {p.shape} [{p.min()}, {p.max()}]")
                    ref = plain.predict_proba(x, lens, adjacency=adj)
                    diff = max(diff, float(np.abs(p - ref).max()))
                    if diff > tol:
                        fail(f"{gt} {dtype} fusion={fusion}: |kernel - plain|"
                             f" = {diff:.3e} > {tol:.0e}")
                log(f"serve {gt} {dtype} input_fusion={fusion}: "
                    f"{sum(len(r[0]) for r in requests)} clips, launches "
                    f"+{rose[fusion]}, max |kernel - plain| {diff:.3e}, "
                    f"mean p {float(np.mean(probs[0])):.4f}")
                if not checked_cpu and dtype == "float32":
                    x, lens, adj = requests[1]
                    cpu = Predictor(cfg, params, device="cpu", batch_size=4)
                    diff = float(np.abs(
                        cpu.predict_proba(x[:4], lens[:4], adjacency=adj[:4])
                        - probs[1][:4]).max())
                    if diff > F32_TOL:
                        fail(f"card vs CPU on 4 clips: {diff:.3e}")
                    log(f"serve {gt} float32: card vs CPU on 4 clips "
                        f"{diff:.3e}")
                    checked_cpu = True
    return {"dcgru_recurrence_xin_fwd": cr.dcgru_recurrence_xin_fwd.launches,
            "dcgru_recurrence_fwd": cr.dcgru_recurrence_fwd.launches}


def phase_times(torch, dev):
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
    from eeg_gnn_tpu_torch.serve import Predictor

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        sb = 2 if dtype == torch.bfloat16 else 4
        for d in (100, 64):
            a = layer_inputs(torch, dev, d=d, m=3, shared=False, b=BATCH,
                             dtype=dtype, seed=100 + d)
            runs = [("dcgru_recurrence_xin_fwd", cr.dcgru_recurrence_xin_fwd,
                     cr.dcgru_recurrence_xin_fwd_plain, xin_args(a), True),
                    ("dcgru_recurrence_fwd", cr.dcgru_recurrence_fwd,
                     cr.dcgru_recurrence_fwd_plain, hoisted_args(a), False)]
            for name, kern, plain, args, xin in runs:
                ms = time_ms(torch, lambda: kern(*args))
                plain_ms = time_ms(torch, lambda: plain(*args))
                work = layer_work(xin=xin, d=d, m=3, b=BATCH, a_batch=BATCH,
                                  stream_bytes=sb)
                bms, by = bound_ms([work])
                out[(name, tag, d)] = (ms, plain_ms, work)
                log(f"time {name} D={d} M=3 B={BATCH} {tag}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{bms:.4f} ms ({by}; {work[0] / 1e9:.2f} GFLOP, "
                    f"{work[1] / 1e6:.2f} MB), {work[0] / ms / 1e9:.2f} "
                    f"TFLOP/s")
    log("library_ms: none — no single PyTorch call computes a DCGRU "
        "recurrence (torch.nn.GRU has no graph diffusion)")

    rng = np.random.RandomState(3)
    x = rng.randn(BATCH, T, N, 100).astype(np.float32)
    lens = np.full((BATCH,), T, np.int64)
    adj = adjacency(rng, BATCH)
    for gt in ("combined", "individual"):
        for dtype in ("bfloat16", "float32"):
            cfg = flagship_cfg(gt, dtype, True)
            pred = Predictor(cfg, build_model(
                cfg, torch.Generator().manual_seed(11)).state_dict())
            ms = time_ms(torch, lambda: pred.predict_proba(x, lens,
                                                           adjacency=adj),
                         lead=False)
            log(f"time Predictor {gt} {dtype} input_fusion=True B={BATCH}: "
                f"{ms:.3f} ms/batch, {BATCH / ms * 1e3:.1f} clips/s "
                "(host numpy in, probabilities out)")
            if dtype == "bfloat16":
                profile_batch(torch, lambda: pred.predict_proba(
                    x, lens, adjacency=adj), f"{gt} {dtype}", ms)
    return out


def profile_batch(torch, fn, tag, wall_ms):
    """Device time by kernel for one traced Predictor batch
    (torch.profiler), and the device's busy share of that batch's wall
    time (the host clock around a call that ends in a device-to-host
    copy)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: CPU ops repeat their kernels' device
        # time, and the profiler's own buffer requests are no work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Activity Buffer")
                and e.self_device_time_total > 0):
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile Predictor {tag}: device busy {busy:.3f} ms of the traced "
        f"batch's {traced_ms:.3f} ms wall ({100 * busy / traced_ms:.1f}%); "
        f"untraced median {wall_ms:.3f} ms")
    for ms, count, key in rows[:10]:
        log(f"profile   {ms:8.3f} ms  x{count:<4d} {key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_build(torch)
    worst, main_abs = phase_parity(torch, dev)
    log(f"parity: worst normalized error {worst}")
    launches = phase_serve(torch)
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} was never launched on the main path")
    times = phase_times(torch, dev)

    kernels = []
    for name, replaces, xin in (
            ("dcgru_recurrence_xin_fwd",
             "eeg_gnn_tpu/ops/pallas_recurrent.py:730", True),
            ("dcgru_recurrence_fwd",
             "eeg_gnn_tpu/ops/pallas_recurrent.py:240", False)):
        # one Predictor batch: layer 0 (D=100) then layer 1 (D=64)
        l0, l1 = times[(name, "bfloat16", 100)], times[(name, "bfloat16", 64)]
        bms, by = bound_ms([l0[2], l1[2]])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "eeg_gnn_tpu_torch/csrc/dcgru_recurrence.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": main_abs[name],
            "ms": l0[0] + l1[0], "plain_ms": l0[1] + l1[1],
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": "2 layers (D=100, 64), T=60, B=128, N=19, H=64, M=3, "
                     "bf16 streams",
        })
    log(f"total {time.perf_counter() - t0:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
