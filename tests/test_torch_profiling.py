"""The port's spans and set-up totals (``utils/profiling.py``) on the CPU:
off, a span is one shared no-op and enters no ``record_function``; under
``profiling.trace`` a cached train step (detector and SSL, through the
input pipeline) writes every ``eeg.step*`` span into the Chrome trace,
nested as the step runs them, and computes the same bits as without it;
``timed`` totals add up across threads; the ``TrainStep`` build, the
pipeline build, a kernel library's build and load and the trainer's
loader waits are timed under their names."""

import json
import os
import pickle
import sys
import threading
import types

import numpy as np
import pytest
import torch

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
from eeg_gnn_tpu_torch.data.scaler import StandardScaler
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.ops import _build
from eeg_gnn_tpu_torch.train.step import TrainStep, make_cached_epoch_step
from eeg_gnn_tpu_torch.train.trainer import Trainer
from eeg_gnn_tpu_torch.utils import profiling

SSL = "SS pre-training"
T_IN, T_OUT, N, D, B = 3, 2, 19, 8, 4
# each span's innermost enclosing span in a train step
PARENT = {"eeg.step": "eeg.plan",
          "eeg.step.zero_grad": "eeg.step",
          "eeg.step.input": "eeg.step",
          "eeg.step.forward": "eeg.step",
          "eeg.step.backward": "eeg.step",
          "eeg.step.update": "eeg.step",
          "eeg.step.clip": "eeg.step.update",
          "eeg.step.adam": "eeg.step.update",
          "Optimizer.step#Adam.step": "eeg.step.adam"}


@pytest.fixture(autouse=True)
def _fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def _pipeline(tmp_path):
    adj = np.full((N, N), 0.1, np.float32) + np.eye(N, dtype=np.float32)
    path = os.path.join(tmp_path, "adj_mx_3d.pkl")
    with open(path, "wb") as f:
        pickle.dump([[], {}, adj], f)
    return make_device_pipeline(
        graph_type="combined", filter_type="laplacian", top_k=3,
        use_fft=True, time_step_size=1, scaler=StandardScaler(0.5, 2.0),
        augment=False, adj_mat_dir=path, device="cpu")


def _cached(tmp_path, task):
    """(a cached epoch step over 2 batches, its TrainStep, x, y)."""
    cfg = ExperimentConfig(
        task=task, graph_type="combined", max_seq_len=T_IN,
        output_seq_len=T_OUT, num_rnn_layers=1, rnn_units=8,
        max_diffusion_step=1, input_dim=D, output_dim=D,
        use_fft=True).finalize()
    stats = {"mean": 0.5, "std": 2.0} if task == SSL else {}
    step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(0)),
                     2, device="cpu", input_pipeline=_pipeline(tmp_path),
                     **stats)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2 * B, T_IN, N, D, generator=gen)
    y = (torch.randn(2 * B, T_OUT, N, D, generator=gen) if task == SSL
         else (torch.rand(2 * B, generator=gen) < 0.5).float())
    return make_cached_epoch_step(step, T_IN, B), step, x, y


def _plan(run, x, y):
    return run(x, y, torch.arange(2 * B), np.full(2, B, np.int32), 0)


def _annotations(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]


def _innermost_parent(e, spans):
    """The shortest other program span (or the optimizer's record) on
    ``e``'s thread that holds it."""
    lo, hi = e["ts"], e["ts"] + e["dur"]
    holders = [p for p in spans if p is not e and p["tid"] == e["tid"]
               and p["ts"] <= lo + 1e-3 and hi <= p["ts"] + p["dur"] + 1e-3
               and p["dur"] >= e["dur"]]
    return min(holders, key=lambda p: p["dur"])["name"] if holders else None


def test_a_span_off_is_the_shared_noop(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("eeg.step")
    assert off is profiling.span("eeg.step.forward")
    with off:
        with profiling.span("eeg.step.clip"):
            pass
    assert entered == [] and profiling.totals() == {}


@pytest.mark.parametrize("task", ["detection", SSL])
def test_spans_enter_record_function_only_under_a_profiler(tmp_path,
                                                           monkeypatch,
                                                           task):
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    run, _, x, y = _cached(tmp_path, task)
    _plan(run, x, y)
    assert entered == []
    with profiling.trace(str(tmp_path / "trace")):
        _plan(run, x, y)
    assert entered.count("eeg.step") == 2 and "eeg.plan" in entered


@pytest.mark.parametrize("task", ["detection", SSL])
def test_a_traced_step_writes_every_span_nested(tmp_path, task):
    run, _, x, y = _cached(tmp_path, task)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _plan(run, x, y)
    spans = [e for e in _annotations(log_dir)
             if e["name"].startswith("eeg.") or e["name"] in PARENT]
    names = [e["name"] for e in spans]
    assert names.count("eeg.plan") == 1
    for name, parent in PARENT.items():
        assert names.count(name) == 2, (name, names)
        for e in spans:
            if e["name"] == name:
                assert _innermost_parent(e, spans) == parent, name


@pytest.mark.parametrize("task", ["detection", SSL])
def test_the_spans_change_no_bit(tmp_path, task):
    plain_run, plain, x, y = _cached(tmp_path, task)
    traced_run, traced, _, _ = _cached(tmp_path, task)
    want = [_plan(plain_run, x, y) for _ in range(2)]
    with profiling.trace(str(tmp_path / "trace")):
        got = [_plan(traced_run, x, y) for _ in range(2)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (name, a), b in zip(traced.model.named_parameters(),
                            plain.model.parameters()):
        assert torch.equal(a, b), name


def test_timed_totals_add_up_across_threads():
    # more threads than cores (at least 4), switching as often as they can
    seen = [[] for _ in range(max(4, (os.cpu_count() or 1) + 1))]

    def work(mine):
        for _ in range(250):
            with profiling.timed("eeg.test.threads") as t:
                pass
            mine.append(t.seconds)

    threads = [threading.Thread(target=work, args=(s,)) for s in seen]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = profiling.totals()["eeg.test.threads"]
    assert total.count == 250 * len(seen)
    assert total.seconds == pytest.approx(sum(map(sum, seen)), rel=1e-9)
    assert all(s >= 0.0 for mine in seen for s in mine)
    profiling.reset()
    assert profiling.totals() == {}


def test_the_train_step_build_is_timed_with_the_optimizer_inside(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        _, step, _, _ = _cached(tmp_path, "detection")
    got = profiling.totals()
    assert got["eeg.setup.train_step"].count == 1
    assert got["eeg.setup.optimizer"].count == 1
    assert got["eeg.setup.pipeline"].count == 1
    assert 0 < got["eeg.setup.optimizer"].seconds \
        <= got["eeg.setup.train_step"].seconds
    setup = [e for e in _annotations(log_dir)
             if e["name"].startswith("eeg.setup.")]
    opt = next(e for e in setup if e["name"] == "eeg.setup.optimizer")
    assert _innermost_parent(opt, setup) == "eeg.setup.train_step"
    assert step.optimizer is not None


def test_kernel_builds_and_loads_are_timed(tmp_path, monkeypatch):
    # a stand-in compiler that writes nothing and succeeds, into a build
    # directory of the test's own
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "true")
    path, seconds, _ = _build.build("sddmm")
    assert os.path.dirname(path) == str(tmp_path) and seconds > 0
    assert _build.build("sddmm")[1] == 0.0  # built: no compiler run
    assert profiling.totals()["eeg.setup.kernel_build"] == (seconds, 1)

    handles = []
    monkeypatch.setattr(_build, "build", lambda name: (name, 0.0, ""))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda p: handles.append(p) or object())
    lib = _build.load("profiling_test_library")
    assert _build.load("profiling_test_library") is lib
    assert handles == ["profiling_test_library"]
    assert profiling.totals()["eeg.setup.kernels"].count == 1


def test_loader_waits_are_timed():
    trainer = types.SimpleNamespace(loaders={"train": ["a", "b"]},
                                    loader_wait_s=0.0)
    assert list(Trainer._batches(trainer, "train")) == ["a", "b"]
    waits = profiling.totals()["eeg.loader.wait"]
    assert waits.count == 3  # two batches and the end
    assert trainer.loader_wait_s == pytest.approx(waits.seconds, rel=1e-9)
