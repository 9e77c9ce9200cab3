"""The Corr-DCRNN benchmark configuration on the CPU, at a small size: the
port's cached individual-graph step (per-clip correlation graphs, dual
random walk, M=5) against the benchmark's plain reference
(``portbench/reference/corr.py`` and ``dcrnn.py``), the float64 graph
against the port's host oracle, the near-tie rule, the faults the check
must catch, the EEG-like features and the program's graph span and
counter."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import eeglike, faults, run, spec
from portbench.drivers import train_cached_corr as drv
from portbench.drivers.common import Context
from portbench.reference import corr as ref_corr

from eeg_gnn_tpu_torch.graphs.xcorr import correlation_adjacency
from eeg_gnn_tpu_torch.utils import profiling

CELL = "detect-train-individual"
SMALL_CFG = {"max_seq_len": 3, "rnn_units": 8, "input_dim": 8}
SMALL_TRAFFIC = {"batch": 4, "split_clips": 16, "warm_steps": 1}
SEED = 2 ** 31 + 11


def _cell():
    w = spec.workload(CELL, spec.benchmark())
    cfg = dict(spec.config(w["config"]), **SMALL_CFG)
    return cfg, dict(spec.traffic(w["traffic"]), **SMALL_TRAFFIC)


def _state(seed=SEED, **config):
    cfg, tr = _cell()
    cfg.update(config)
    ctx = Context(cell=CELL, cfg=cfg, traffic=tr, seed=seed,
                  device=torch.device("cpu"))
    st = drv.setup(ctx)
    drv.release(st)
    return st


def test_the_configuration_is_the_published_corr_dcrnn():
    bench = spec.benchmark()
    w = spec.workload(CELL, bench)
    cfg = spec.config(w["config"])
    base = spec.config("dcrnn-detect-60s")
    assert (cfg["graph_type"], cfg["filter_type"], cfg["top_k"]) == (
        "individual", "dual_random_walk", 3)
    for key in ("num_rnn_layers", "rnn_units", "max_diffusion_step",
                "num_nodes", "max_seq_len", "input_dim", "lr_init", "l2_wd",
                "max_grad_norm", "dtype"):
        assert cfg[key] == base[key], key
    assert drv.program_config(cfg).num_supports == 2
    assert cfg["reduced"] == ["data_augment"] and w["chips"] == 1
    assert set(spec.limits(CELL)) == {"loss_gap", "grad1_gap",
                                      "change_gap_median", "supports_gap"}


@pytest.mark.parametrize("seed,layers", [(SEED, 2), (7, 1)])
def test_the_cached_step_matches_the_reference(seed, layers):
    """Loss, first gradients and the change after 3 steps of the port's
    cached individual-graph step, and its supports, against the plain
    float32 reference trained on float64 graphs."""
    st = _state(seed, num_rnn_layers=layers)
    got = drv.compare(st, drv.program_readings(st))
    assert got["loss_gap"] <= 1e-6, got
    assert got["grad1_gap"] <= 1e-5, got
    assert got["change_gap_median"] <= 1e-4, got
    assert got["supports_gap"] <= 1e-6, got
    assert got["near_tie_share"] <= 0.05, got
    # every step ran per-clip supports: one (2, B, N, N) slab a batch
    sup = st.readings["supports"]
    assert sup.shape == (2, 3 * st.batch, 19, 19)
    assert not torch.equal(sup[:, 0], sup[:, 1])


@pytest.mark.parametrize("top_k", [3, 5])
def test_the_float64_graph_matches_the_host_oracle(top_k):
    cfg, tr = _cell()
    x = eeglike.features(6, cfg, tr, SEED, "cpu")
    corr = ref_corr.abs_correlation(x)
    adj = ref_corr.adjacency(corr, ref_corr.top_k_mask(corr, top_k))
    for i in range(x.shape[0]):
        want = correlation_adjacency(x[i].numpy(), top_k=top_k)
        np.testing.assert_allclose(adj[i].numpy(), want, rtol=0, atol=1e-7)
        assert ((adj[i] > 0).sum(1) == top_k + 1).all()


def _tie_case():
    """One clip of 6 nodes whose node 0 has a near tie between columns 3
    and 4 (1e-9 apart), whose node 1 has a clear cut (0.1 apart), and
    whose other nodes' neighbours lie 0.05 apart."""
    corr = (0.05 * torch.arange(1, 7, dtype=torch.float64)).expand(
        1, 6, 6).clone()
    corr[0, 0, 1:] = torch.tensor([0.9, 0.8, 0.7, 0.7 - 1e-9, 0.2])
    corr[0, 1] = torch.tensor([0.5, 1.0, 0.9, 0.8, 0.7, 0.6])
    corr[0] = torch.where(torch.eye(6, dtype=torch.bool), 1.0, corr[0])
    return corr


@pytest.mark.parametrize("node,swap,taken", [
    (0, None, False),     # the float64 choice itself
    (0, (3, 4), True),    # the tie's other column: within the band
    (0, (1, 5), False),   # a column well above the band dropped
    (1, (4, 5), False),   # a clear cut crossed: 0.1 outside tie_bound
])
def test_the_near_tie_rule(node, swap, taken):
    corr = _tie_case()
    own = ref_corr.top_k_mask(corr, 3)
    choice = own.clone()
    if swap is not None:
        a, b = swap
        choice[0, node, a], choice[0, node, b] = False, True
    mask, near, took = ref_corr.resolve_ties(corr, 3, 1e-6, choice)
    assert near[0].tolist() == [True] + [False] * 5
    assert bool(took[0, node]) == taken
    assert torch.equal(mask, choice if (taken or swap is None) else own)
    gap = (ref_corr.supports(ref_corr.adjacency(corr, mask))
           - ref_corr.supports(ref_corr.adjacency(corr, choice))).abs().max()
    assert (gap == 0) == (taken or swap is None)


@pytest.mark.parametrize("cut,taken", [(0.5, True), (2.0, False)])
def test_the_band_is_the_fixed_tie_bound(cut, taken):
    """Node 0's 3rd and 4th |corr| lie ``cut`` times the driver's fixed
    ``TIE_BOUND`` apart: swapping them is the program's choice within the
    band, and a flip outside it, which the reference refuses."""
    corr = _tie_case()
    corr[0, 0, 4] = 0.7 - cut * drv.TIE_BOUND
    choice = ref_corr.top_k_mask(corr, 3)
    choice[0, 0, 3], choice[0, 0, 4] = False, True
    mask, near, took = ref_corr.resolve_ties(corr, 3, drv.TIE_BOUND, choice)
    assert bool(near[0, 0]) == bool(took[0, 0]) == taken
    assert torch.equal(mask, choice) == taken


@pytest.mark.parametrize("fault", drv.FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    with faults.BY_NAME[fault]():
        res = run.run_cell(CELL, SEED, 0.2, False, device="cpu",
                           overrides={"config": SMALL_CFG,
                                      "traffic": SMALL_TRAFFIC})
    failed = {k for k, c in res["compared"].items()
              if c["value"] is None or c["value"] > c["limit"]}
    assert not res["correct"] and failed, res["compared"]
    if fault == "one_graph":
        assert "supports_gap" in failed


def test_a_sound_run_is_correct():
    res = run.run_cell(CELL, SEED, 0.2, False, device="cpu",
                       overrides={"config": SMALL_CFG,
                                  "traffic": SMALL_TRAFFIC})
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_eeglike_features_are_seeded_and_scaled(monkeypatch):
    cfg, tr = _cell()
    cfg = dict(cfg, max_seq_len=20, input_dim=50)
    # three chunks, the last one short
    monkeypatch.setattr(eeglike, "CHUNK_CLIPS", 16)
    a = eeglike.features(40, cfg, tr, SEED, "cpu")
    b = eeglike.features(40, cfg, tr, SEED, "cpu")
    c = eeglike.features(40, cfg, tr, SEED + 1, "cpu")
    assert a.shape == (40, 20, 19, 50)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for chunk in (a[:16], a[32:]):
        assert chunk.mean().item() == pytest.approx(cfg["feature_mean"],
                                                    abs=0.02)
        assert chunk.std().item() == pytest.approx(cfg["feature_std"],
                                                   rel=0.05)
    # each clip's graph is its own
    corr = ref_corr.abs_correlation(a)
    assert (ref_corr.top_k_mask(corr[:1], 3)
            != ref_corr.top_k_mask(corr[1:], 3)).any()


def test_the_graph_span_and_counter(tmp_path):
    """A traced cached step builds each clip's graph under
    ``eeg.step.graph`` inside ``eeg.step.input`` and counts its clips;
    untraced, it counts nothing."""
    cfg, tr = _cell()
    st = drv.setup(Context(cell=CELL, cfg=cfg, traffic=tr, seed=SEED,
                           device=torch.device("cpu")))
    profiling.reset()
    b, steps = st.batch, 2
    plan = torch.arange(steps * b)
    valid = np.full(steps, b, np.int32)
    st.run(st.x, st.y, plan, valid, 0)
    assert "eeg.step.graph_clips" not in profiling.totals()
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir):
        st.run(st.x, st.y, plan, valid, 0)
    assert profiling.totals()["eeg.step.graph_clips"].count == steps * b
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    graphs = [e for e in events if e["name"] == "eeg.step.graph"]
    inputs = [e for e in events if e["name"] == "eeg.step.input"]
    assert len(graphs) == steps and len(inputs) == steps
    for g in graphs:
        assert any(i["ts"] <= g["ts"] and g["ts"] + g["dur"]
                   <= i["ts"] + i["dur"] + 1e-3 for i in inputs)
    reader = spec.metric_reader("graph_clips_per_step.corr")
    ctx = {"info": {"steps": steps}, "detail_info": {"steps": 0}}
    assert reader.read(ctx) == b
    profiling.reset()
    assert reader.read(ctx) is None
