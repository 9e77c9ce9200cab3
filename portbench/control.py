"""Readings that set the limits of a cell's check, on the card.

    python3 -m portbench.control --workload <cell> --seeds=1,2,... \
        --control-seeds=7,8,9 [--seconds 3]

For every seed of ``--seeds`` the program's readings, and for every seed
of ``--control-seeds`` also the control's (the reference computed in
TF32, put in the program's place) and each fault's (planted in the
program, ``portbench/faults.py``), all at the cell's own sizes, in one
process. A driver whose readings come from its window
(``READINGS_IN_WINDOW``) runs a window of ``--seconds`` first. Prints one
JSON line a reading and a summary: the largest program reading of each
number (the lower reading), and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from portbench import faults, spec
from portbench.run import set_cache_env


def _run(drv, ctx, seconds, fault=None):
    import contextlib

    with (fault() if fault else contextlib.nullcontext()):
        st = drv.setup(ctx)
        if drv.READINGS_IN_WINDOW:
            drv.window(st, seconds)
    drv.release(st)
    return st


def readings(cell: str, seeds, control_seeds, seconds: float,
             device=None, overrides=None, emit=print) -> dict:
    import torch

    from portbench.drivers.common import Context

    bench = spec.benchmark()
    w = spec.workload(cell, bench)
    cfg = dict(spec.config(w["config"]))
    traffic = dict(spec.traffic(w["traffic"]))
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    dev = torch.device(device or "cuda")
    drv = spec.driver(traffic["kind"])
    plants = {name: faults.BY_NAME[name] for name in drv.FAULTS}
    table = {}

    def note(seed, variant, numbers, detail=None):
        line = {"cell": cell, "seed": seed, "variant": variant,
                "numbers": {k: (v if math.isfinite(v) else None)
                            for k, v in numbers.items()}}
        if detail:
            line["leaves"] = detail
        emit(json.dumps(line))
        for k, v in numbers.items():
            table.setdefault(variant, {}).setdefault(k, []).append(v)

    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                      device=dev)
        st = _run(drv, ctx, seconds)
        if seed in seeds:
            prog = drv.program_readings(st)
            note(seed, "program", drv.compare(st, prog),
                 drv.leaf_detail(st, prog) if hasattr(drv, "leaf_detail")
                 else None)
        if seed in control_seeds:
            note(seed, "control", drv.compare(
                st, drv.reference_readings(st, "tf32")))
            for name, plant in plants.items():
                bad = _run(drv, ctx, seconds, plant)
                bad.reference = st.reference
                note(seed, "fault:" + name,
                     drv.compare(bad, drv.program_readings(bad)))
        del st
    summary = {}
    for variant, nums in table.items():
        pick = max if variant == "program" else min
        summary[variant] = {k: (pick(v) if math.isfinite(pick(v)) else None)
                            for k, v in nums.items()}
    emit(json.dumps({"cell": cell, "summary": summary}))
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    set_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    ints = lambda s: [int(v) for v in s.split(",") if v]
    readings(args.workload, ints(args.seeds), ints(args.control_seeds),
             args.seconds, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
