"""The readers of the program's own spans on a made-up trace: each reads
its value from ``eeg.step.*`` user annotations, and finds nothing in a
trace without them (an older program's); the idle gaps are named by the
innermost program span; the set-up reader reads the program's totals."""

import sys
import types

import pytest

from eeg_gnn_tpu_torch.utils import profiling
from portbench import spans, spec, trace

KINDS = ["train", "ssl"]
SPAN_METRICS = ["input_ms_per_step", "update_ms_per_step",
                "update_launches_per_step"]


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _event("cuda_runtime", "cudaLaunchKernel", ts, 2, tid=tid,
                  correlation=corr)


def _kernel(name, ts, dur, corr):
    return _event("kernel", name, ts, dur, tid=7, correlation=corr)


def _step(t0, corr):
    """One step of 1000 us from ``t0``: the input (two kernels), the
    forward (one), a backward kernel launched from another thread, the
    update (the clip's three kernels, Adam's one), the device idle between
    them."""
    ann = [("eeg.step", 0, 1000), ("eeg.step.input", 0, 200),
           ("eeg.step.forward", 200, 300), ("eeg.step.backward", 500, 200),
           ("eeg.step.update", 700, 280), ("eeg.step.clip", 710, 120),
           ("eeg.step.adam", 840, 130),
           ("Optimizer.step#Adam.step", 850, 110)]
    ev = [_event("user_annotation", n, t0 + a, d) for n, a, d in ann]
    plan = [(10, "vectorized_gather_kernel", 20),
            (20, "elementwise_kernel_128", 30),
            (210, "dcgru_fwd_kernel", 150),
            (510, "dcgru_xin_bwd_loop_kernel", 60),
            (720, "reduce_kernel", 10), (730, "elementwise_kernel", 5),
            (740, "elementwise_kernel", 5),
            (860, "multi_tensor_apply_kernel", 40)]
    for i, (at, name, dur) in enumerate(plan):
        c = corr + i
        # backward kernels come from autograd's own thread
        ev.append(_launch(t0 + at, c, tid=2 if at == 510 else 1))
        ev.append(_kernel(name, t0 + at + 5, dur, c))
    return ev


def _trace(with_spans=True):
    ev = [_event("user_annotation", trace.TRACED, 0, 2500),
          _event("user_annotation", "eeg.plan", 80, 2270)]
    ev += _step(100, 1) + _step(1300, 100)
    if not with_spans:
        ev = [e for e in ev if not e["name"].startswith("eeg.")]
    return trace.Trace(ev, window_s=2500e-6)


def _ctx(tr, steps=2):
    info = {"steps": steps, "batch": 256}
    return {"trace": tr, "info": info, "detail": tr, "detail_info": info,
            "cfg": spec.config("dcrnn-detect-60s"), "traffic": {},
            "rates": {}, "root": spec.ROOT}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.mark.parametrize("kind", KINDS)
def test_span_readers_on_a_made_up_trace(kind):
    ctx = _ctx(_trace())
    # the gather's 20 us and the standardize's 30 us a step
    assert _read(f"input_ms_per_step.{kind}", ctx) == pytest.approx(0.05)
    # clip 10 + 5 + 5, Adam 40
    assert _read(f"update_ms_per_step.{kind}", ctx) == pytest.approx(0.06)
    assert _read(f"update_launches_per_step.{kind}", ctx) == 4.0
    # the metric's Adam part is the accepted reader's
    assert _read(f"adam_ms_per_step.{kind}", ctx) == pytest.approx(0.04)


def test_update_launches_less_adams_are_the_clips():
    tr = _trace()
    update = spans.correlations(tr, spans.UPDATE)
    adam = spans.correlations(tr, "Optimizer.step#Adam.step")
    clip = spans.correlations(tr, "eeg.step.clip")
    assert adam <= update and clip <= update
    assert len(update - adam) == len(clip) == 6
    # the backward's kernels, launched from another thread, are not
    # tied to its span
    assert spans.correlations(tr, "eeg.step.backward") == set()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_find_nothing_without_the_spans(metric, kind):
    assert _read(f"{metric}.{kind}", _ctx(_trace(False))) is None
    assert _read(f"{metric}.{kind}", _ctx(trace.Trace([], 1.0))) is None
    assert _read(f"{metric}.{kind}", _ctx(_trace(), steps=0)) is None


def test_idle_gaps_are_named_by_the_innermost_program_span():
    labels = dict(_trace().idle_gaps())
    # each gap goes whole to the innermost span over its midpoint: in
    # each step 160 us from the standardize's end to the forward's kernel
    # (under the input span), 150 after the forward's and after the
    # backward's kernel, 5 + 115 in the clip
    assert labels == pytest.approx({
        "eeg.step.input": 320e-6, "eeg.step.forward": 300e-6,
        "eeg.step.backward": 300e-6, "eeg.step.clip": 240e-6,
        # between the steps, inside the plan; before and after it
        "eeg.plan": 310e-6, "host outside any torch record": 410e-6})
    without = dict(_trace(False).idle_gaps())
    assert without == pytest.approx(
        {"host outside any torch record": sum(labels.values())})


def test_the_step_build_is_read_from_the_programs_totals(monkeypatch):
    profiling.reset()
    assert _read("setup_step_build_s", {}) is None
    with profiling.timed("eeg.setup.train_step") as build:
        pass
    assert _read("setup_step_build_s", {}) == build.seconds
    profiling.reset()
    # a program without the totals (an older one) reads nothing
    monkeypatch.setitem(sys.modules, "eeg_gnn_tpu_torch.utils.profiling",
                        types.ModuleType("eeg_gnn_tpu_torch.utils.profiling"))
    assert _read("setup_step_build_s", {}) is None


def test_the_span_metrics_are_declared():
    bench = spec.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for metric in SPAN_METRICS:
        for kind, cell, rate in (("train", "detect-train-f32",
                                  "train_clips_per_s"),
                                 ("ssl", "ssl-train-f32",
                                  "train_pairs_per_s")):
            m = per_layer[f"{metric}.{kind}"]
            assert m["workloads"] == [cell] and m["moves"] == rate
            assert m["source"] == "device_trace"
    build = per_layer["setup_step_build_s"]
    assert build["moves"] == "setup_s" and build["source"] == "program_span"
    assert build["workloads"] == ["detect-train-f32", "ssl-train-f32"]
