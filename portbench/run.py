"""One run of one benchmark cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (process start to the first timed step: the program's import, its
kernels loaded or built, the weights and data made on the card from the
seed, the cell's shapes warmed up), then the measured window, then, with
``--trace 1``, a traced part after it, then the check that decides
``correct``. The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are also the last
lines of standard error.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import spec  # noqa: E402

# every build and kernel cache of a run stays inside the checkout, at
# fixed paths, so only a checkout's first run builds
CACHE_DIR = os.path.join(spec.ROOT, ".portbench_cache")
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "eeg_gnn_tpu")


def set_cache_env():
    for var, sub in CACHE_ENV.items():
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line(torch) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    return f"card: {name}; power limit: {smi[0] if smi else 'not read'}"


def prebuild_kernels():
    """Build the program's CUDA libraries in parallel (a no-op where they
    are built), so a first run does not build them one by one."""
    from concurrent.futures import ThreadPoolExecutor

    from eeg_gnn_tpu_torch.ops import _build

    names = [f[:-3] for f in sorted(os.listdir(_build.CSRC_DIR))
             if f.endswith(".cu")]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        for f in [pool.submit(_build.build, n) for n in names]:
            f.result()


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, overrides=None, bench=None, t_start=None) -> dict:
    """Run a cell; returns the result object. ``device`` and
    ``overrides`` ({"config": {...}, "traffic": {...}}) serve the tests,
    which run it small on the CPU."""
    import torch

    from portbench.drivers.common import Context

    t_start = _T_START if t_start is None else t_start
    bench = spec.benchmark() if bench is None else bench
    w = spec.workload(cell, bench)
    cfg = dict(spec.config(w["config"]))
    traffic = dict(spec.traffic(w["traffic"]))
    limits = spec.limits(cell)
    if overrides:
        cfg.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = spec.driver(traffic["kind"])
    ctx = Context(cell=cell, cfg=cfg, traffic=traffic, seed=seed, device=dev)

    t_cell = time.perf_counter()
    st = drv.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {t_cell - t_start:.3f} s to the cell's set-up (imports, "
          f"the card, the kernels), {setup_s - (t_cell - t_start):.3f} s "
          "the cell's (weights, data, first steps, warm-up)",
          file=sys.stderr)
    res = drv.window(st, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    e2e = {m["name"]: m for m in spec.metrics_of(cell, bench, "end_to_end")}
    values = dict(res["metrics"], setup_s=setup_s)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": w["chips"], "memory_peak_bytes": int(peak)}
    out = {}
    breakdown = None
    if trace:
        from portbench import trace as tracing

        # the steady part with the device's activity alone; a short part
        # with the host's operators too, for what runs under a host record
        # and what the host did in the idle gaps
        tr, info = tracing.capture(lambda: drv.traced(st, False), False)
        detail, detail_info = tracing.capture(lambda: drv.traced(st, True),
                                              True)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": detail.idle_gaps()}
        ctx_m = {"trace": tr, "info": info, "detail": detail,
                 "detail_info": detail_info, "cfg": cfg, "traffic": traffic,
                 "rates": values, "root": spec.ROOT}
        for m in spec.metrics_of(cell, bench, "per_layer"):
            v = spec.metric_reader(m["name"]).read(ctx_m)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for name, m in e2e.items():
            if name in values:
                out[name] = {"value": float(values[name]), "unit": m["unit"]}

    drv.release(st)
    numbers = drv.compare(st, drv.program_readings(st))
    # the numbers the cell's limits name; one not finite is written as
    # null, and fails
    compared = {k: {"value": float(numbers[k]) if math.isfinite(numbers[k])
                    else None, "limit": float(v)} for k, v in limits.items()}
    correct = (res["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": out,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    set_cache_env()
    import torch

    bench = spec.benchmark()
    chips = spec.workload(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    print(card_line(torch), flush=True)
    prebuild_kernels()
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print("portbench: the run loaded " + ", ".join(bad)
              + "; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
