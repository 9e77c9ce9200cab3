#!/usr/bin/env python3
"""Where a step of the serial state loops spends its time, on one CUDA
card (an NVIDIA H100): the encoder's two loops and the seq2seq decoder's.

Run from the repository root:

    python3 loop_probe.py [--only encoder|decoder|dw|proj|dx|fdc] [--sass DIR]
        [--batch B] [--shared]

It builds ``csrc/dcgru_recurrence.cu``, ``csrc/dcgru_recurrence_bwd.cu``
and ``csrc/dcgru_decoder.cu`` once more with ``-DDCGRU_PROBE`` (a variant
library beside the real one: thread 0 of every block reads the SM clock
at each barrier of a step and block 0 keeps the sums), runs the loops
through their wrappers and prints, per step, the clocks block 0 spent in
each phase, from one barrier to the next, beside the launch's time from
CUDA events (the probe build's, weight staging included; the probe adds
a few clock reads a step); M=3 and 5, bf16 and f32 streams, B=128 and a
single clip.

- The encoder's loops at the flagship layer's shape (T=60, N=19, H=64).
  Phases of the forward: the diffusions of h, the gate product and its
  epilogue, the diffusions of r*h, the candidate product and the state
  update (and the wait for the next step's x_proj); of the backward: P0
  (streams in, g, du, dc_pre), P2 (dc_pre Wc^T), P3 (A^T: drh, dr_pre),
  P4 (dru_pre Wg^T), P5 (A^T: dh).
- The decoder's loops at the SSL model's shape (T_out=12, N=19, H=64,
  D=100, L=3), clocks per layer-step: layer 0's and the tied layers' (a
  mean over layers 1..L-1) four phases each, and the per-step phase. The
  forward's: the diffusions of [h | in], the gate product, the diffusions
  of r*h, the candidate product and the state update; then the
  projection and the next input. The backward's: dproj Wp^T with the top
  layer's head (g, du, dc_pre); then per layer dc_pre Wc^T, the A^T apply
  of drh (dr_pre, g u + drh r), the gate and input products, the A^T
  applies of dh and of the input cotangent (with the head of the layer
  below, or the previous step's dproj and dx). Each case's launch plan
  (staged-weight bytes in shared memory) is printed beside it.

With ``--only dw`` it probes the bulk dW kernel instead
(``csrc/dcgru_xin_gemm.cu`` built with ``-DDCGRU_PROBE``,
``cuda_recurrent.dcgru_xin_dw``): thread 0 of three blocks of the first
split, one of each role, reads the SM clock at each phase of a chunk of
rows, and the probe prints each role's clocks per chunk and
phase beside the launch's time from CUDA events and the launch plan
(splits, pairs a split and a chunk, rows a chunk, shared bytes and
threads a block, blocks a split and an SM), at the detector's two layers
(T=60, B=128, D=100 and 64) and the SSL decoder's two launches (layer 0
at D=100 over T_out=12 steps; the tied cell at D=64 over (L-1)*T_out=24
stacked steps), M=3, bf16 and f32 streams, with ptxas' register and
spill report of the dW kernels. A block owns one m and one 64-column
tile of dpre; the three roles are m=0 on the first gate tile (which
also sums db), and m=M-1 on the first gate and the first candidate
tile.

With ``--only proj`` or ``--only dx`` it probes the bulk projection or
dx kernel (``xin_bulk_kernel`` of ``csrc/dcgru_xin_gemm.cu``, built with
``-DDCGRU_PROBE``, through ``cuda_recurrent.dcgru_xin_proj`` /
``dcgru_xin_dx``): thread 0 of block 0 (the first column tile's first
walker) reads the SM clock at each phase of a chunk, and the probe prints
the clocks per chunk: the wait for the chunk's In rows, the barrier
before each m's F (with the wait on the operators' copies), the F_0
copy, the diffusions F_m = Op_m In, the barrier after, the products and
the output stores; beside the launch's time from CUDA events and the launch
plan (``cuda_recurrent.xin_bulk_plan``), at the detector's two layers
(T=60, B=128 or ``--batch B``, D=100 and 64, M=3, per-clip operators or,
with ``--shared``, one graph), bf16 and f32, with ptxas' register and
spill report of the probed kernels.

With ``--only fdc`` it probes the fused diffusion conv of the
``use_pallas`` loop (``csrc/fused_diffusion_conv.cu`` built with
``-DDCGRU_PROBE``, through ``cuda_kernels.fused_diffusion_conv_fwd`` with
operands staged once, as the loop hands them over): thread 0 of block 0
reads the SM clock at each phase of its clip, and the probe prints the
clocks a launch spent in each: the operand copy (the clip's x and
supports, and the weight fragments' wait), the Chebyshev terms, the
products (with the partials' stores and the barrier after them) and the
output store; beside the launch's time from CUDA events and the launch
plan (``cuda_kernels.fdc_plan``), at the loop's shapes (B=128, N=19,
D=H=64; the gate, O=128, and the candidate, O=64; M=3 and 5) and at one
clip (B=1), with ptxas' register and spill report.

It also prints each probed kernel's size in SASS instructions
(``cuobjdump -sass``): most of a step's code runs once a step; with
``--sass DIR`` it writes the probe libraries' SASS listings there. Exits
non-zero without a card.
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
T_OUT, D, L = 12, 100, 3
REPS = 10
SLOTS = 48  # csrc kProbeSlots
PHASES = {
    "fwd": ("diffuse h", "gate product", "diffuse r*h",
            "candidate product"),
    "bwd": ("P0 streams", "P2 dc Wc^T", "P3 A^T drh", "P4 dru Wg^T",
            "P5 A^T dh"),
    # the decoder's, by probe slot: (name, layers it sums over)
    "dec_fwd": (("l0 diffuse [h|in]", "l0"), ("l0 gate product", "l0"),
                ("l0 diffuse r*h", "l0"), ("l0 candidate product", "l0"),
                ("tied diffuse [h|in]", "tied"),
                ("tied gate product", "tied"),
                ("tied diffuse r*h", "tied"),
                ("tied candidate product", "tied"),
                ("projection", "step")),
    "dec_bwd": (("dproj Wp^T + top head", "step"),
                ("tied dc Wc^T", "tied"), ("tied A^T drh", "tied"),
                ("tied Wg, Wx products", "tied"),
                ("tied A^T dh, din + head", "tied"),
                ("l0 dc Wc^T", "l0"), ("l0 A^T drh", "l0"),
                ("l0 Wg, Wx products", "l0"),
                ("l0 A^T dh, din + dproj", "l0")),
}


# the dW probe: 12 slots a block role (csrc/dcgru_xin_gemm.cu, xin_dw_kernel)
DW_SLOTS = 12
DW_CHUNKS = 10  # the slot that counts a role's chunks
DW_ROLES = ("m=0 gate tile (+db)", "m=M-1 gate tile",
            "m=M-1 candidate tile")
DW_PHASES = ("prologue", "copies' wait", "barrier A",
             "producer: issue x, h", "prep: G = A^T dpre, r h, db",
             "barrier B", "producer: issue dpre, ru, A", "mma + flush",
             "epilogue")
# (name, T, D) of the dW launches probed: the detector's layers and the
# SSL decoder's layer 0 and tied cell (L=3: 2 stacked layers)
DW_CASES = (("detector layer 0", T, D), ("detector layer 1", T, H),
            ("decoder layer 0", T_OUT, D),
            ("decoder tied cell", (L - 1) * T_OUT, H))


def sass_sizes(path: str, listing: str | None = None,
               keep=("loop", "fwd")) -> dict:
    """SASS instructions of each kernel in the library at ``path`` whose
    name holds one of ``keep``, by kernel name; empty where the toolkit
    has no cuobjdump. ``listing``: also write the whole SASS listing to
    that file."""
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
    return {k: v for k, v in sizes.items() if any(w in k for w in keep)}


def time_launches(torch, fn, args, kw, read) -> tuple[float, list]:
    """(ms per launch, block 0's clocks per probe slot summed over REPS
    launches) of ``fn(*args, **kw)`` after one warm-up launch."""
    fn(*args, **kw)
    torch.cuda.synchronize()
    read()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn(*args, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS, read()


def probe_encoder(torch, cr, read, results):
    from eeg_gnn_tpu_torch.ops.recurrent import (
        chebyshev_operators,
        shift_h_prev,
    )

    dev = torch.device("cuda")
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
                    ms, slots = time_launches(torch, fn, args, {},
                                              lambda k=kind: read(k))
                    names = PHASES[kind]
                    per_step = [c / (REPS * T) for c in slots[:len(names)]]
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


def probe_decoder(torch, cd, read, results):
    from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

    dev = torch.device("cuda")
    for num_supports in (1, 2):
        m = num_supports * K + 1
        for stream in (torch.bfloat16, torch.float32):
            bf16 = stream == torch.bfloat16
            for b in (128, 1):
                rng = np.random.RandomState(7 * m + b)
                f = lambda *s, scale: torch.from_numpy(
                    (rng.randn(*s) * scale).astype(np.float32)).to(dev)
                sup = torch.from_numpy((np.abs(rng.randn(
                    num_supports, b, N, N)) / N).astype(np.float32))
                a_ops = chebyshev_operators(sup, K).contiguous().to(dev)

                def cell(d_in):
                    s = (2.0 / (m * (d_in + 2 * H))) ** 0.5
                    return [f(m * d_in, 2 * H, scale=s),
                            f(m * d_in, H, scale=s),
                            f(m * H, 2 * H, scale=s), f(m * H, H, scale=s),
                            f(2 * H, scale=0.1), f(H, scale=0.1)]

                w = cell(D) + cell(H) + [f(H, D, scale=H ** -0.5),
                                         f(D, scale=0.1)]
                h0 = f(L, b, N, H, scale=0.1)
                force = torch.tensor([float(i % 2) for i in range(T_OUT)],
                                     device=dev)
                fwd = (a_ops, f(T_OUT, b, N, D, scale=1.0).to(stream),
                       force, *w, h0, L)
                _, _, h_seq, ru, c = cd.dcgru_decoder_fwd(*fwd,
                                                         residuals=True)
                bwd = (a_ops, *w[0:4], *w[6:10], w[12],
                       cd.decoder_h_prev(h0, h_seq), ru, c,
                       f(T_OUT, b, N, D, scale=1.0).to(stream), force, L)
                for kind, fn, args, kw in (
                        ("fwd", cd.dcgru_decoder_fwd, fwd,
                         dict(residuals=True)),
                        ("bwd", cd.dcgru_dec_bwd_loop, bwd, {})):
                    ms, slots = time_launches(torch, fn, args, kw,
                                              lambda: read("dec"))
                    plan = cd.decoder_plan(kind == "fwd", N, D, H, m, L,
                                           bf16)
                    steps = {"l0": REPS * T_OUT, "step": REPS * T_OUT,
                             "tied": REPS * T_OUT * (L - 1)}
                    phases = {name: slots[i] / steps[per] for i, (name, per)
                              in enumerate(PHASES["dec_" + kind])}
                    # clocks of a whole step: every layer's phases
                    total = sum(slots[:len(phases)]) / (REPS * T_OUT)
                    row = {"loop": "dec_" + kind, "M": m, "B": b,
                           "streams": str(stream)[6:], "ms": ms,
                           "us_per_step": ms * 1e3 / T_OUT,
                           "cycles_per_step": total,
                           "clock_ghz": total / (ms * 1e3 / T_OUT) / 1e3,
                           "plan": plan, "phases": phases}
                    results.append(row)
                    print(f"probe decoder {kind} L={L} M={m} "
                          f"{row['streams']} B={b} (plan: "
                          f"{plan['in_smem']} of {plan['staged']} staged "
                          f"bytes in shared memory, {plan['smem']} bytes "
                          f"a block): {ms:.4f} ms/launch, "
                          f"{row['us_per_step']:.2f} us/step; block 0: "
                          f"{total:.0f} cycles/step; per layer-step "
                          + ", ".join(f"{p} {c:.0f}"
                                      for p, c in phases.items()),
                          flush=True)


def probe_dw(torch, cr, lib, read, results):
    from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

    dev = torch.device("cuda")
    m, b = K + 1, 128  # the combined graph's operators: M=3
    plan_keys = ("splits", "pairs_per_split", "pairs_per_chunk",
                 "rows_per_chunk", "smem_bytes", "threads",
                 "blocks_per_split", "blocks_per_sm")
    for name, t, d in DW_CASES:
        for stream in (torch.bfloat16, torch.float32):
            rng = np.random.RandomState(t + d)
            f = lambda *s, scale=1.0: torch.from_numpy(
                (rng.randn(*s) * scale).astype(np.float32)).to(dev)
            sup = torch.from_numpy((np.abs(rng.randn(1, b, N, N)) / N)
                                   .astype(np.float32))
            a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
            args = (a_ops, f(t, b, N, H, scale=0.5).to(stream),
                    torch.sigmoid(f(t, b, N, 2 * H)).to(stream),
                    f(t, b, N, d).to(stream), f(t, b, N, 3 * H, scale=0.1))
            ms, slots = time_launches(torch, cr.dcgru_xin_dw, args, {},
                                      read)
            out = (ctypes.c_int * 8)()
            bf16 = int(stream == torch.bfloat16)
            if lib.dcgru_xin_dw_plan(t, b, N, d, H, m, bf16,
                                     ctypes.addressof(out)):
                raise RuntimeError("dcgru_xin_dw_plan failed")
            plan = dict(zip(plan_keys, list(out)))
            roles = {}
            for r, role in enumerate(DW_ROLES):
                s = slots[r * DW_SLOTS:(r + 1) * DW_SLOTS]
                chunks = s[DW_CHUNKS] / REPS
                per_chunk = {p: s[i] / max(s[DW_CHUNKS], 1)
                             for i, p in enumerate(DW_PHASES)
                             if p not in ("prologue", "epilogue")}
                roles[role] = {
                    "chunks": chunks,
                    "block_cycles": sum(s[:len(DW_PHASES)]) / REPS,
                    "prologue": s[0] / REPS,
                    "epilogue": s[len(DW_PHASES) - 1] / REPS,
                    "per_chunk": per_chunk}
            row = {"kernel": "dcgru_xin_dw", "case": name, "T": t, "B": b,
                   "D": d, "M": m, "streams": str(stream)[6:], "ms": ms,
                   "plan": plan, "roles": roles}
            results.append(row)
            print(f"probe dw {name} T={t} D={d} M={m} {row['streams']}: "
                  f"{ms:.4f} ms/launch; plan {plan}", flush=True)
            for role, v in roles.items():
                print(f"  {role}: {v['chunks']:.0f} chunks, "
                      f"{v['block_cycles']:.0f} cycles a block (prologue "
                      f"{v['prologue']:.0f}, epilogue {v['epilogue']:.0f});"
                      " per chunk " + ", ".join(
                          f"{p} {c:.0f}" for p, c in v["per_chunk"].items())
                      + f"; total {sum(v['per_chunk'].values()):.0f}",
                      flush=True)


# the bulk projection and dx probes (csrc/dcgru_xin_gemm.cu,
# xin_bulk_kernel): block 0's thread 0, clocks per slot; BULK_CHUNKS
# counts its chunks, BULK_PIECES its (chunk, m) pieces
BULK_PHASES = ("prologue", "In wait", "barrier A", "F_0 copy",
               "diffusion F_m", "barrier B", "mma", "stores", "epilogue")
# the f32 body's (xin_bulk_tf32_wgmma_kernel): its F_0 is In itself, and
# slot 3 holds the wait for the chunk's last wgmma; "wgmma issue" is the
# products' (the weight slices' waits among them). dx on the output side
# (D=64): "barrier A" waits for the last chunk's diffusion, "barrier B"
# holds Y's stores, "diffusion F_m" dx's diffusion and stores
BULK_PHASES_F32 = ("prologue", "In wait", "barrier A", "wgmma drain",
                   "diffusion F_m", "barrier B", "wgmma issue", "stores",
                   "epilogue")
BULK_CHUNKS, BULK_PIECES = 10, 11
BULK_CASES = (("detector layer 0", D), ("detector layer 1", H))
# the fused diffusion conv's probe (csrc/fused_diffusion_conv.cu,
# fdc_kernel): block 0's thread 0, clocks per slot summed over launches
FDC_PHASES = ("operand copy", "Chebyshev terms", "products", "store")


def probe_bulk(torch, cr, kind, read, results, b=128, shared=False):
    """The bulk projection (``kind`` "proj") or dx kernel at the detector's
    two layers (T=60, B=``b``, M=3, per-clip operators or, with
    ``shared``, one graph for every clip), bf16 and f32."""
    from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

    dev = torch.device("cuda")
    m = K + 1
    for name, d in BULK_CASES:
        for stream in (torch.bfloat16, torch.float32):
            rng = np.random.RandomState(d)
            f = lambda *s, scale=1.0: torch.from_numpy(
                (rng.randn(*s) * scale).astype(np.float32)).to(dev)
            sup = torch.from_numpy((np.abs(rng.randn(
                1, 1 if shared else b, N, N)) / N).astype(np.float32))
            a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
            wx = f(m * d, 3 * H, scale=0.1)
            if kind == "proj":
                fn = cr.dcgru_xin_proj
                args = (f(T, b, N, d).to(stream), a_ops, wx)
            else:
                fn = cr.dcgru_xin_dx
                args = (a_ops, wx, f(T, b, N, 3 * H, scale=0.1), stream)
            ms, slots = time_launches(torch, fn, args, {}, read)
            plan = cr.xin_bulk_plan(kind == "proj", T, b, N, d, H, m,
                                    1 if shared else b,
                                    stream == torch.bfloat16)
            chunks = slots[BULK_CHUNKS] / REPS
            phases = (BULK_PHASES if stream == torch.bfloat16
                      else BULK_PHASES_F32)
            per = {p: slots[i] / max(slots[BULK_CHUNKS], 1)
                   for i, p in enumerate(phases)
                   if p not in ("prologue", "epilogue")}
            row = {"kernel": "dcgru_xin_" + kind, "case": name, "T": T,
                   "B": b, "D": d, "M": m, "shared_graph": shared,
                   "streams": str(stream)[6:],
                   "ms": ms, "plan": plan, "chunks": chunks,
                   "block_cycles": sum(slots[:len(BULK_PHASES)]) / REPS,
                   "prologue": slots[0] / REPS,
                   "epilogue": slots[len(BULK_PHASES) - 1] / REPS,
                   "per_chunk": per}
            results.append(row)
            print(f"probe {kind} {name} B={b} D={d} M={m} "
                  f"{'shared' if shared else 'per-clip'} {row['streams']}: "
                  f"{ms:.4f} ms/launch; plan {plan}; block 0: "
                  f"{chunks:.0f} chunks, {row['block_cycles']:.0f} cycles "
                  f"(prologue {row['prologue']:.0f}, epilogue "
                  f"{row['epilogue']:.0f}); per chunk " + ", ".join(
                      f"{p} {c:.0f}" for p, c in per.items())
                  + f"; total {sum(per.values()):.0f}", flush=True)


def probe_fdc(torch, ck, read, results):
    """The fused diffusion conv at the use_pallas loop's shapes: the gate
    (O=2H) and candidate (O=H) launches of one step, M=3 (S=1) and M=5
    (S=2), B=128 and a single clip, operands staged once."""
    dev = torch.device("cuda")
    for s in (1, 2):
        m = s * K + 1
        for b in (128, 1):
            for name, o in (("gate", 2 * H), ("candidate", H)):
                rng = np.random.RandomState(s * o + b)
                sup = torch.from_numpy((np.abs(rng.randn(s, b, N, N)) / N)
                                       .astype(np.float32)).to(dev)
                f = lambda *sh, scale: torch.from_numpy(
                    (rng.randn(*sh) * scale).astype(np.float32)).to(dev)
                w = f(m, H, o, scale=0.1)
                sup_f, (w_f,) = ck.stage_fdc_operands(sup, w)
                args = (sup, torch.tanh(f(b, N, H, scale=1.0)), w,
                        f(o, scale=0.1), K, (sup_f, w_f))
                ms, slots = time_launches(torch, ck.fused_diffusion_conv_fwd,
                                          args, {}, read)
                plan = ck.fdc_plan(s, b, N, H, o, K)
                phases = {p: slots[i] / REPS for i, p in enumerate(FDC_PHASES)}
                total = sum(phases.values())
                row = {"kernel": "fused_diffusion_conv_fwd", "case": name,
                       "M": m, "B": b, "O": o, "ms": ms, "plan": plan,
                       "block_cycles": total, "phases": phases}
                results.append(row)
                print(f"probe fdc {name} O={o} M={m} B={b}: {ms:.4f} "
                      f"ms/launch; plan {plan}; block 0: {total:.0f} "
                      "cycles (" + ", ".join(
                          f"{p} {c:.0f}, {100 * c / total:.0f}%"
                          for p, c in phases.items()) + ")", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("loop_probe.py: torch.cuda.is_available() is false")
    sass_dir = sys.argv[sys.argv.index("--sass") + 1] \
        if "--sass" in sys.argv else None
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv else None
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
    from eeg_gnn_tpu_torch.ops import _build
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = (("fwd", "dcgru_recurrence", cr.bind_fwd),
               ("bwd", "dcgru_recurrence_bwd", cr.bind_bwd),
               ("dec", "dcgru_decoder", cd.bind),
               ("dw", "dcgru_xin_gemm", cr.bind_xin),
               ("fdc", "fused_diffusion_conv", ck.bind))
    part = {"fwd": ("encoder",), "bwd": ("encoder",), "dec": ("decoder",),
            "dw": ("dw", "proj", "dx"), "fdc": ("fdc",)}
    sources = [s for s in sources if only in part[s[0]]
               or (only is None and s[0] not in ("dw", "fdc"))]
    libs = {}
    for kind, name, bind in sources:
        path, secs, report = _build.build(name, ("-DDCGRU_PROBE",))
        lib = bind(ctypes.CDLL(path))
        lib.dcgru_probe_read.argtypes = [ctypes.c_void_p]
        lib.dcgru_probe_read.restype = ctypes.c_int
        libs[kind] = lib
        print(f"build {name}.cu -DDCGRU_PROBE in {secs:.1f} s", flush=True)
        # the probed kernels' names: dW's, the projection's (PROJ=true)
        # or dx's instances of xin_bulk_kernel (bf16) and
        # xin_bulk_tf32_wgmma_kernel (f32)
        mark = {"dw": "xin_dw", "proj": "kernelILb1",
                "dx": "kernelILb0", "fdc": "fdc_kernel"}.get(only, "")
        keep = (mark,) if kind in ("dw", "fdc") else ("loop", "fwd")
        if kind in ("dw", "fdc"):
            entry = ""
            for line in report.splitlines():
                if "Compiling entry" in line:
                    entry = line
                elif mark in entry and any(w in line for w in (
                        "registers", "spill", "wgmma")):
                    print(f"ptxas {entry.split()[-3]} {line.strip()}",
                          flush=True)
        listing = (os.path.join(sass_dir, f"{name}.sass") if sass_dir
                   else None)
        for fn, count in sass_sizes(path, listing, keep).items():
            print(f"sass {name}.cu {fn}: {count} instructions", flush=True)
    # the wrappers launch the probe builds
    if "fwd" in libs:
        cr._lib = lambda: libs["fwd"]
        cr._lib_bwd = lambda: libs["bwd"]
    if "dec" in libs:
        cd._lib = lambda: libs["dec"]
    if "fdc" in libs:
        ck._lib = lambda: libs["fdc"]
    if "dw" in libs:
        cr._lib_xin = lambda: libs["dw"]
        libs["dw"].dcgru_xin_dw_plan.argtypes = [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        libs["dw"].dcgru_xin_dw_plan.restype = ctypes.c_int

    def read(kind):
        buf = (ctypes.c_ulonglong * SLOTS)()
        err = libs[kind].dcgru_probe_read(ctypes.addressof(buf))
        if err:
            raise RuntimeError(f"dcgru_probe_read: CUDA error {err}")
        return list(buf)

    results = []
    if "fwd" in libs:
        probe_encoder(torch, cr, read, results)
    if "dec" in libs:
        probe_decoder(torch, cd, read, results)
    if only == "dw":
        probe_dw(torch, cr, libs["dw"], lambda: read("dw"), results)
    elif only in ("proj", "dx"):
        b = int(sys.argv[sys.argv.index("--batch") + 1]) \
            if "--batch" in sys.argv else 128
        probe_bulk(torch, cr, only, lambda: read("dw"), results, b,
                   "--shared" in sys.argv)
    elif only == "fdc":
        probe_fdc(torch, ck, lambda: read("fdc"), results)
    print(json.dumps({"loop_probe": results}), flush=True)


if __name__ == "__main__":
    main()
