"""The harness on the CPU: what it imports, how it finds its pieces by
name, ``BENCHMARK.json``'s names and units, the per-layer readers on a
made-up trace, and whole runs at a tiny size with and without a fault
planted under the timed path."""

import ast
import json
import os
import re
import shutil

import pytest
import torch

from portbench import faults, run, spec, trace
from portbench.work.counts import bound_ms
from portbench.work.model import dcgru_work

FORBIDDEN = {"jax", "jaxlib", "flax", "eeg_gnn_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(spec.PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: eeg_gnn_tpu_torch begins with the
    JAX package's name and is allowed."""
    for path in _sources():
        if os.path.basename(os.path.dirname(path)) == "tests":
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"eeg_gnn_tpu_torch"}, (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "eeg_gnn_tpu_torch_x", object())
    assert run.forbidden_modules() == [] or "jax" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "eeg_gnn_tpu.fake", object())
    assert "eeg_gnn_tpu" in run.forbidden_modules()


def test_benchmark_json_names_and_units():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
        names.append(c["name"])
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\t" not in w["why"]
        assert os.path.exists(os.path.join(spec.PKG, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(spec.PKG, "limits",
                                           w["name"] + ".json"))
        cells.append(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= set(cells)
            if group == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0 < m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and m["layer"]
                assert os.path.exists(os.path.join(
                    spec.PKG, "metrics", m["name"] + ".py"))
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(w["name"], bench,
                                                       "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        for m in spec.metrics_of(w["name"], bench, "per_layer"):
            assert m["moves"] in reported, (w["name"], m["name"])
        rate = spec.traffic(w["traffic"]).get("rate_metric")
        assert rate is None or rate in reported


def test_a_dropped_in_cell_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and edits none: a traffic mix, a cell's
    limits and a metric reader in a copy are found by their names."""
    pkg = tmp_path / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "detect-train-f32-b40",
                               "config": "dcrnn-detect-60s",
                               "traffic": "train-cached-b40", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "new_metric.train", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves":
                               "train_clips_per_s",
                               "workloads": ["detect-train-f32-b40"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (pkg / "traffic" / "train-cached-b40.json").write_text(json.dumps(
        {"kind": "train_cached_epochs", "split_clips": 1600}))
    (pkg / "limits" / "detect-train-f32-b40.json").write_text("{}")
    (pkg / "metrics" / "new_metric.train.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    got = spec.benchmark(str(tmp_path))
    assert spec.workload("detect-train-f32-b40", got)["chips"] == 1
    assert spec.traffic("train-cached-b40", str(pkg))["split_clips"] == 1600
    assert spec.limits("detect-train-f32-b40", str(pkg)) == {}
    names = [m["name"] for m in spec.metrics_of("detect-train-f32-b40",
                                                got, "per_layer")]
    assert names == ["new_metric.train"]
    assert spec.metric_reader("new_metric.train", str(pkg)).read({}) == 42.0
    assert spec.driver("train_cached_epochs").setup


# --------------------------------------------------------------------------
# the readers on a made-up trace
# --------------------------------------------------------------------------


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def _made_up_trace():
    ev = [_event("user_annotation", trace.TRACED, 0, 1000),
          _event("user_annotation", "Optimizer.step#Adam.step", 500, 100),
          _event("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
          _event("cuda_runtime", "cudaLaunchKernel", 510, 5, correlation=2),
          _event("cuda_runtime", "cudaMemcpyAsync", 20, 5, correlation=3),
          _event("cpu_op", "aten::pad", 700, 250),
          _event("kernel", "void (anonymous namespace)::dcgru_fwd_kernel"
                 "<float, 3>(Params)", 100,
                 300, correlation=1),
          _event("kernel", "multi_tensor_apply_kernel", 520, 40,
                 correlation=2),
          _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300, 200,
                 correlation=3)]
    return trace.Trace(ev, window_s=1000e-6)


def _ctx(tr, info, cfg=None, rates=None):
    cfg = cfg or spec.config("dcrnn-detect-60s")
    return {"trace": tr, "info": info, "detail": tr, "detail_info": info,
            "cfg": cfg, "traffic": {}, "rates": rates or {},
            "root": spec.ROOT}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.mark.parametrize("kind", ["train", "ssl"])
def test_readers_on_a_made_up_trace(kind):
    tr = _made_up_trace()
    assert tr.busy_s() == pytest.approx(440e-6)  # [100, 500] and [520, 560]
    cfg = spec.config("dcrnn-detect-60s" if kind == "train"
                      else "dcrnn-ssl-60s-12s")
    train = _ctx(tr, {"steps": 2, "batch": 128}, cfg)
    assert _read(f"device_idle_share.{kind}", train) == pytest.approx(56.0)
    assert _read(f"launches_per_step.{kind}", train) == 1.0
    assert _read(f"adam_ms_per_step.{kind}", train) == pytest.approx(0.02)
    want = 100 * 2 * bound_ms(dcgru_work(cfg, 128, True))[0] * 1e-3 / 300e-6
    assert _read(f"dcgru_roofline.{kind}", train) == pytest.approx(want)
    assert tr.device_ops()[0][0] == "dcgru_fwd_kernel<float, 3>"
    # gaps [0, 100], [500, 520], [560, 1000], each named by the innermost
    # host record over its midpoint
    labels = dict(tr.idle_gaps())
    assert labels["aten::pad"] == pytest.approx(440e-6)
    assert labels["cudaLaunchKernel"] == pytest.approx(20e-6)
    assert labels["host outside any torch record"] == pytest.approx(100e-6)


def test_readers_find_nothing_in_an_empty_trace():
    tr = trace.Trace([], window_s=1.0)
    for name in ("dcgru_roofline", "adam_ms_per_step",
                 "launches_per_step", "device_idle_share"):
        for kind in ("train", "ssl"):
            assert _read(f"{name}.{kind}",
                         _ctx(tr, {"steps": 3, "batch": 128})) is None
    for name in ("mfu.train", "mfu.ssl"):
        assert _read(name, _ctx(tr, {})) is None
    rate = _read("mfu.train", _ctx(tr, {}, rates={"train_clips_per_s": 1e4}))
    assert 0 < rate < 100
    ssl = spec.config("dcrnn-ssl-60s-12s")
    assert _read("mfu.ssl", _ctx(tr, {}, ssl, {"train_pairs_per_s": 1e4})) \
        > rate


def test_handwritten_kernels_are_read_from_the_sources():
    names = trace.handwritten_kernels(os.path.join(spec.ROOT,
                                                   "eeg_gnn_tpu_torch",
                                                   "csrc"))
    assert {"dcgru_fwd_kernel", "xin_bulk_kernel", "xin_dw_kernel",
            "dcgru_xin_bwd_loop_kernel", "dw_reduce_kernel",
            "dcgru_dec_fwd_kernel"} <= names
    assert "__launch_bounds__" not in names


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", "detect-train-f32", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


# --------------------------------------------------------------------------
# whole runs, tiny, on the CPU
# --------------------------------------------------------------------------

TINY_CFG = {"max_seq_len": 3, "rnn_units": 8, "output_seq_len": 2}
TINY_TRAFFIC = {"batch": 4, "split_clips": 16, "warm_steps": 1}


def _tiny(cell, seed=2 ** 31 + 5, plant=None, **config):
    cfg = dict(TINY_CFG, input_dim=8, output_dim=8, **config)
    over = {"config": cfg, "traffic": TINY_TRAFFIC}
    if plant is None:
        return run.run_cell(cell, seed, 0.3, False, device="cpu",
                            overrides=over)
    with plant():
        return run.run_cell(cell, seed, 0.3, False, device="cpu",
                            overrides=over)


CELLS = ["detect-train-f32", "ssl-train-f32"]
# a later SSL cell may turn scheduled sampling on by its configuration alone
CURRICULUM = {"use_curriculum_learning": True, "batches_seen_start": 24000}


@pytest.mark.parametrize("cell,config", [(c, {}) for c in CELLS]
                         + [("ssl-train-f32", CURRICULUM)])
def test_a_sound_run_is_correct(cell, config):
    res = _tiny(cell, **config)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert res["metrics"]["setup_s"]["value"] > 0


FAULTS = [(c, f) for c in CELLS
          for f in spec.driver("train_cached_epochs").FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    res = _tiny(cell, plant=faults.BY_NAME[fault])
    assert not res["correct"], res["compared"]
