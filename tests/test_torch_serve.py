"""The port's serving slice against the JAX package: ``Predictor`` end to
end on the CPU, JAX weights carried across (tree and ``.npz``), the
initialisation statistics, the no-fallback device rule, and the rule that
the port imports neither JAX nor the JAX package."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.serve import Predictor as JaxPredictor
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.io import load_jax_npz, params_from_jax
from eeg_gnn_tpu_torch.models.dcgru import DCGRUConfig, init_dcgru_cell
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.serve import Predictor

T, N, D = 6, 19, 100
REPO = pathlib.Path(__file__).resolve().parents[1]


def _kw(**kw):
    base = dict(graph_type="individual", max_seq_len=T, num_rnn_layers=2,
                rnn_units=16, max_diffusion_step=2, input_dim=D,
                test_batch_size=4)
    base.update(kw)
    return base


def _jax_params(jcfg):
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params


def _adjacency(rng, n):
    adj = np.abs(rng.rand(n, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    return adj


def _inputs(rng, n):
    x = rng.randn(n, T, N, D).astype(np.float32)
    lens = rng.randint(1, T + 1, size=n)
    return x, lens, _adjacency(rng, n)


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
@pytest.mark.parametrize("input_fusion", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_matches_jax(rng, graph_type, input_fusion, dtype):
    """The whole slice: JAX Predictor (stacked path off-TPU, float32) vs
    the port's Predictor on the CPU with the same weights; n=7 with batch
    4 makes the last chunk pad."""
    jcfg = JaxConfig(do_train=True, **_kw(graph_type=graph_type)).finalize()
    params = _jax_params(jcfg)
    x, lens, adj = _inputs(rng, 7)
    want = JaxPredictor(jcfg, params).predict_proba(x, lens, adjacency=adj)

    cfg = ExperimentConfig(**_kw(graph_type=graph_type, dtype=dtype,
                                 input_fusion=input_fusion)).finalize()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = Predictor(cfg, sd, device="cpu").predict_proba(x, lens,
                                                         adjacency=adj)
    assert got.shape == (7,) and np.all((got >= 0) & (got <= 1))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


def test_predictor_supports_argument_and_classification(rng):
    """Precomputed ``supports`` instead of ``adjacency``; 4-class softmax."""
    from eeg_gnn_tpu.graphs import compute_supports_jnp

    kw = _kw(graph_type="combined", num_classes=4, task="classification")
    jcfg = JaxConfig(do_train=True, **kw).finalize()
    params = _jax_params(jcfg)
    x, lens, adj = _inputs(rng, 5)
    sup = np.asarray(compute_supports_jnp(adj, jcfg.filter_type))
    want = JaxPredictor(jcfg, params).predict_proba(x, lens, supports=sup)
    pred = Predictor(ExperimentConfig(**kw).finalize(),
                     params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params)),
                     device="cpu")
    got = pred.predict_proba(x, lens, supports=sup)
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    decisions, probs = pred.predict(x, lens, supports=sup)
    np.testing.assert_array_equal(decisions, probs.argmax(axis=-1))


def test_predict_threshold_stream_and_chunking(rng):
    cfg = ExperimentConfig(**_kw()).finalize()
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    x, lens, adj = _inputs(rng, 10)
    pred = Predictor(cfg, params, device="cpu", threshold=0.5)
    probs = pred.predict_proba(x, lens, adjacency=adj)
    big = Predictor(cfg, params, device="cpu", batch_size=16)
    np.testing.assert_allclose(probs, big.predict_proba(x, lens,
                                                        adjacency=adj),
                               rtol=2e-5, atol=2e-6)
    decisions, p2 = pred.predict(x, lens, adjacency=adj)
    np.testing.assert_array_equal(decisions, (p2 > 0.5).astype(np.int64))
    streamed = list(pred.stream([
        {"x": x[:3], "seq_lengths": lens[:3], "adjacency": adj[:3]},
        {"x": x[3:], "seq_lengths": lens[3:], "adjacency": adj[3:]}]))
    np.testing.assert_allclose(np.concatenate(streamed), probs, rtol=1e-6)


def test_npz_round_trip(rng):
    """JAX train/checkpoint.save_params -> load_jax_npz -> Predictor equals
    the JAX predictor and the port's from_checkpoint."""
    from eeg_gnn_tpu.train.checkpoint import save_params

    jcfg = JaxConfig(do_train=True, **_kw()).finalize()
    params = _jax_params(jcfg)
    cfg = ExperimentConfig(**_kw()).finalize()
    x, lens, adj = _inputs(rng, 3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "best.npz")
        save_params(path, params)
        sd = load_jax_npz(path, cfg)
        loaded = Predictor.from_checkpoint(path, cfg, device="cpu")
    for key, value in params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items():
        torch.testing.assert_close(sd[key], value, rtol=0, atol=0)
    want = JaxPredictor(jcfg, params).predict_proba(x, lens, adjacency=adj)
    np.testing.assert_allclose(loaded.predict_proba(x, lens, adjacency=adj),
                               want, rtol=1e-4, atol=1e-5)


def test_state_dict_keys_follow_the_jax_tree():
    cfg = ExperimentConfig(**_kw()).finalize()
    keys = set(build_model(cfg).state_dict())
    assert keys == {f"encoder.{i}.{k}" for i in range(2)
                    for k in ("gate_w", "gate_b", "cand_w", "cand_b")} \
        | {"fc.weight", "fc.bias"}


def test_init_dcgru_cell_statistics():
    """Xavier-normal weights with gain 1.414, zero biases (the reference
    bias-init quirk), reference-layout shapes."""
    cfg = DCGRUConfig(100, 64, 2, N, 2)  # M = 5
    p = init_dcgru_cell(torch.Generator().manual_seed(0), cfg)
    d_total = (100 + 64) * 5
    assert p["gate_w"].shape == (d_total, 128)
    assert p["cand_w"].shape == (d_total, 64)
    assert torch.count_nonzero(p["gate_b"]) == 0
    assert torch.count_nonzero(p["cand_b"]) == 0
    for name, out in (("gate_w", 128), ("cand_w", 64)):
        want = 1.414 * (2.0 / (d_total + out)) ** 0.5
        w = p[name]
        assert abs(w.std().item() / want - 1.0) < 0.02, name
        assert abs(w.mean().item()) < 0.05 * want, name


def test_predictor_without_device_needs_cuda(monkeypatch):
    cfg = ExperimentConfig(**_kw()).finalize()
    params = build_model(cfg).state_dict()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, params, device="cuda")


def test_unported_paths_raise(tmp_path):
    """A mesh axis other than data and graph raises (the data axis
    serves: its two-rank run in tests/test_torch_dp_cli.py; the graph
    axis's ring: tests/test_torch_graph_axis.py), and a data mesh whose
    ranks do not split the batch evenly is refused; the baselines, which
    raised here before they were ported, build and serve (their parity
    with JAX: tests/test_torch_baselines.py)."""
    from eeg_gnn_tpu_torch.io import save_torch_checkpoint
    from eeg_gnn_tpu_torch.parallel.mesh import Mesh, check_axes

    cfg = ExperimentConfig(**_kw()).finalize()
    params = build_model(cfg).state_dict()
    check_axes(("data", "graph"))
    for axes in (("data", "model"), ("graph", "graph")):
        with pytest.raises(ValueError, match="mesh ax"):
            check_axes(axes)
    mesh = Mesh(("data",), (3,), 0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        Predictor(cfg, params, batch_size=4, mesh=mesh)
    rng = np.random.RandomState(4)
    x, lens, adj = _inputs(rng, 3)
    for name in ("lstm", "cnnlstm", "densecnn"):
        bcfg = dataclasses.replace(cfg, model_name=name, use_fft=True)
        xb = x
        if name == "densecnn":  # its pools take at least 7 s: 700 rows
            with pytest.raises(ValueError, match="at least 700 rows"):
                build_model(bcfg)
            bcfg = dataclasses.replace(bcfg, max_seq_len=7)
            xb = rng.randn(3, 7 * 100, N).astype(np.float32)  # flat clips
        model = build_model(bcfg, torch.Generator().manual_seed(1))
        path = str(tmp_path / f"{name}.pth.tar")
        save_torch_checkpoint(path, model.state_dict())
        probs = Predictor.from_checkpoint(path, bcfg, device="cpu"
                                          ).predict_proba(xb, lens,
                                                          adjacency=adj)
        assert probs.shape == (3,) and np.all((probs >= 0) & (probs <= 1))


def test_finalize_sets_filter_type_from_graph_type():
    assert ExperimentConfig(graph_type="combined").finalize().filter_type \
        == "laplacian"
    cfg = ExperimentConfig(graph_type="individual").finalize()
    assert cfg.filter_type == "dual_random_walk" and cfg.num_supports == 2


_FORBIDDEN = ("jax", "jaxlib", "optax", "eeg_gnn_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in _FORBIDDEN)


def test_port_sources_import_no_jax():
    """AST scan of every module of the port (``parallel/``, the graph
    axis's modules, ``utils/``, ``entry.py``, the offline input path and
    ``viz/`` included), its card scripts and the rank workers of the
    multi-rank tests."""
    port = REPO / "eeg_gnn_tpu_torch"
    files = sorted(port.rglob("*.py"))
    assert len(files) >= 14
    assert port / "train" / "step.py" in files
    for name in ("__init__.py", "mesh.py", "distributed.py",
                 "edge_partition.py", "sparse_model.py"):
        assert port / "parallel" / name in files
    for name in ("graphs/sparse.py", "utils/timing.py", "utils/profiling.py",
                 "entry.py", "data/edf.py", "cli/preprocess.py",
                 "data/clipstore.py", "viz/__init__.py", "viz/graph_viz.py"):
        assert port / name in files
    for path in files + [REPO / "chip_smoke.py", REPO / "serve_ab.py",
                         REPO / "tests" / "torch_dp_cases.py",
                         REPO / "tests" / "torch_graph_cases.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, eeg_gnn_tpu_torch.serve, "
            "eeg_gnn_tpu_torch.models.registry, eeg_gnn_tpu_torch.io, "
            "eeg_gnn_tpu_torch.train, eeg_gnn_tpu_torch.ops.cuda_kernels, "
            "eeg_gnn_tpu_torch.ops.sddmm, eeg_gnn_tpu_torch.graphs.xcorr, "
            "eeg_gnn_tpu_torch.cli.train, eeg_gnn_tpu_torch.train.trainer, "
            "eeg_gnn_tpu_torch.data, eeg_gnn_tpu_torch.data.synthetic, "
            "eeg_gnn_tpu_torch.data.device_pipeline, "
            "eeg_gnn_tpu_torch.data.device_cache, "
            "eeg_gnn_tpu_torch.data.rotating_cache, "
            "eeg_gnn_tpu_torch.parallel, eeg_gnn_tpu_torch.parallel.mesh, "
            "eeg_gnn_tpu_torch.parallel.distributed, "
            "eeg_gnn_tpu_torch.graphs.sparse, "
            "eeg_gnn_tpu_torch.parallel.edge_partition, "
            "eeg_gnn_tpu_torch.parallel.sparse_model, "
            "eeg_gnn_tpu_torch.utils.timing, "
            "eeg_gnn_tpu_torch.utils.profiling, eeg_gnn_tpu_torch.entry, "
            "eeg_gnn_tpu_torch.data.edf, eeg_gnn_tpu_torch.cli.preprocess, "
            "eeg_gnn_tpu_torch.data.clipstore, eeg_gnn_tpu_torch.viz, "
            "eeg_gnn_tpu_torch.viz.graph_viz; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
