#!/usr/bin/env python3
"""Where a step of the encoder's state loops spends its time, on one CUDA
card (an NVIDIA H100).

Run from the repository root:

    python3 loop_probe.py [--sass DIR]

It builds ``csrc/dcgru_recurrence.cu`` and ``csrc/dcgru_recurrence_bwd.cu``
once more with ``-DDCGRU_PROBE`` (a variant library beside the real one:
thread 0 of every block reads the SM clock at each barrier of a step and
block 0 keeps the sums), runs both loops through their wrappers at the
flagship layer's shape (T=60, N=19, H=64; M=3 and 5; bf16 and f32
streams; B=128 and a single clip) and prints, per step, the clocks block
0 spent in each phase, from one barrier to the next, beside the launch's
time from CUDA events (the probe build's, weight staging included; the
probe adds a few clock reads a step). Phases of the forward: the
diffusions of h, the gate product and its epilogue, the diffusions of
r*h, the candidate product and the state update (and the wait for the
next step's x_proj); of the backward: P0 (streams in, g, du, dc_pre),
P2 (dc_pre Wc^T), P3 (A^T: drh, dr_pre), P4 (dru_pre Wg^T), P5 (A^T:
dh). It also prints each loop kernel's size in SASS instructions
(``cuobjdump -sass``): most of a step's code runs once a step; with
``--sass DIR`` it writes the two probe libraries' SASS listings there.
Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

T, N, H, K = 60, 19, 64, 2
REPS = 10
PHASES = {
    "fwd": ("diffuse h", "gate product", "diffuse r*h",
            "candidate product"),
    "bwd": ("P0 streams", "P2 dc Wc^T", "P3 A^T drh", "P4 dru Wg^T",
            "P5 A^T dh"),
}


def sass_sizes(path: str, listing: str | None = None) -> dict:
    """SASS instructions of each loop kernel in the library at ``path``,
    by kernel name; empty where the toolkit has no cuobjdump. ``listing``:
    also write the whole SASS listing to that file."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300).stdout
    if listing:
        with open(listing, "w") as fh:
            fh.write(out)
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[name] += 1
    return {k: v for k, v in sizes.items() if "loop" in k or "fwd" in k}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("loop_probe.py: torch.cuda.is_available() is false")
    sass_dir = sys.argv[sys.argv.index("--sass") + 1] \
        if "--sass" in sys.argv else None
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
    from eeg_gnn_tpu_torch.ops import _build
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
    from eeg_gnn_tpu_torch.ops.recurrent import (
        chebyshev_operators,
        shift_h_prev,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {}
    for kind, name, bind in (("fwd", "dcgru_recurrence", cr.bind_fwd),
                             ("bwd", "dcgru_recurrence_bwd", cr.bind_bwd)):
        path, secs, _ = _build.build(name, ("-DDCGRU_PROBE",))
        lib = bind(ctypes.CDLL(path))
        lib.dcgru_probe_read.argtypes = [ctypes.c_void_p]
        lib.dcgru_probe_read.restype = ctypes.c_int
        libs[kind] = lib
        print(f"build {name}.cu -DDCGRU_PROBE in {secs:.1f} s", flush=True)
        listing = (os.path.join(sass_dir, f"{name}.sass") if sass_dir
                   else None)
        for fn, count in sass_sizes(path, listing).items():
            print(f"sass {name}.cu {fn}: {count} instructions", flush=True)
    # the wrappers launch the probe builds
    cr._lib = lambda: libs["fwd"]
    cr._lib_bwd = lambda: libs["bwd"]

    def read(kind):
        buf = (ctypes.c_ulonglong * 8)()
        err = libs[kind].dcgru_probe_read(ctypes.addressof(buf))
        if err:
            raise RuntimeError(f"dcgru_probe_read: CUDA error {err}")
        return list(buf)

    dev = torch.device("cuda")
    results = []
    for num_supports in (1, 2):
        m = num_supports * K + 1
        for stream in (torch.bfloat16, torch.float32):
            for b in (128, 1):
                rng = np.random.RandomState(m * b)
                f = lambda *s, scale=0.1: torch.from_numpy(
                    (rng.randn(*s) * scale).astype(np.float32)).to(dev)
                sup = torch.from_numpy((np.abs(rng.randn(
                    num_supports, b, N, N)) / N).astype(np.float32))
                a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
                wg, wc, bg, bc = f(m, H, 2 * H), f(m, H, H), f(2 * H), f(H)
                h0, xp = f(b, N, H), f(T, b, N, 3 * H, scale=0.5)
                fwd = (xp, a_ops, wg, wc, bg, bc, h0, "tanh", True, stream)
                h_seq, ru, c = cr.dcgru_xin_fwd_loop(*fwd)
                bwd = (a_ops, wg, wc, shift_h_prev(h0, h_seq), ru, c,
                       f(T, b, N, H, scale=1.0).to(stream))
                for kind, fn, args in (("fwd", cr.dcgru_xin_fwd_loop, fwd),
                                       ("bwd", cr.dcgru_xin_bwd_loop, bwd)):
                    fn(*args)
                    torch.cuda.synchronize()
                    read(kind)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(REPS):
                        fn(*args)
                    end.record()
                    end.synchronize()
                    ms = start.elapsed_time(end) / REPS
                    names = PHASES[kind]
                    per_step = [c / (REPS * T) for c in read(kind)[:len(names)]]
                    total = sum(per_step)
                    row = {"loop": kind, "M": m, "B": b,
                           "streams": str(stream)[6:], "ms": ms,
                           "us_per_step": ms * 1e3 / T,
                           "cycles_per_step": total,
                           "clock_ghz": total / (ms * 1e3 / T) / 1e3,
                           "phases": dict(zip(names, per_step))}
                    results.append(row)
                    print(f"probe {kind} M={m} {row['streams']} B={b}: "
                          f"{ms:.4f} ms/launch, {row['us_per_step']:.2f} "
                          f"us/step; block 0: {total:.0f} cycles/step ("
                          + ", ".join(f"{p} {c:.0f}, {100 * c / total:.0f}%"
                                      for p, c in zip(names, per_step))
                          + ")", flush=True)
    print(json.dumps({"loop_probe": results}), flush=True)


if __name__ == "__main__":
    main()
