"""The port's on-device input pipeline against the JAX package's, on the
CPU: the batched FFT featurizer, ``DevicePipeline`` (its ``features`` and
``ssl_features`` tails, individual and combined graphs, augmentation off
and on with the JAX key's draws fed in, reflection's swapped supports),
the ``reflect_invariant`` fast path, and ``Predictor``'s raw front door.

Inputs are made from a seed with numpy. Tolerances: featurization
(numpy's complex FFT, XLA's and torch's rfft) 1e-4 absolute on log
amplitudes; the tails 1e-5 (the same float32 arithmetic); probabilities
rtol 1e-4, atol 1e-5; bf16 storage against JAX float32 at 2e-2 of the
largest magnitude (the port's bf16 rule, ROADMAP.md Queue 3).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.data import device_pipeline as jdp
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.ops.fft_features import featurize_clip as jax_featurize
from eeg_gnn_tpu.serve import Predictor as JaxPredictor
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.constants import FREQUENCY
from eeg_gnn_tpu_torch.data import device_pipeline as tdp
from eeg_gnn_tpu_torch.data.scaler import StandardScaler
from eeg_gnn_tpu_torch.graphs.supports import compute_supports
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.ops.fft_features import (
    featurize_clip,
    featurize_clip_np,
)
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train.step import supervised_loss_fn

B, T, N, D = 8, 4, 19, 100
FEAT_ATOL = 1e-4
TAIL_ATOL = 1e-5
SCALER = StandardScaler(mean=np.float64(0.3), std=np.float64(2.0))
FILTER = {"individual": "dual_random_walk", "combined": "laplacian"}


@pytest.fixture()
def dist_pkl(tmp_path):
    rng = np.random.RandomState(3)
    adj = np.abs(rng.rand(N, N)).astype(np.float32)
    adj = (adj + adj.T) / 2
    np.fill_diagonal(adj, 1.0)
    path = str(tmp_path / "adj.pkl")
    with open(path, "wb") as f:
        pickle.dump([["c"] * N, {}, adj], f)
    return path


def _pipes(graph_type, dist_pkl, augment=True, reflect_invariant=False):
    kw = dict(graph_type=graph_type, filter_type=FILTER[graph_type],
              top_k=3, use_fft=True, time_step_size=1, scaler=SCALER,
              augment=augment, adj_mat_dir=dist_pkl,
              reflect_invariant=reflect_invariant)
    return (jdp.make_device_pipeline(**kw),
            tdp.make_device_pipeline(device="cpu", **kw))


def _jax_draws(key, b):
    """The draws JAX's features() makes from ``key`` (device_pipeline.py:
    119-127)."""
    k_ref, k_scale = jax.random.split(key)
    reflect = jax.random.bernoulli(k_ref, 0.5, (b,))
    scale = jax.random.uniform(k_scale, (b,), minval=0.8, maxval=1.2)
    return (torch.from_numpy(np.array(reflect)),
            torch.from_numpy(np.array(scale)))


def _feats(rng, t=T):
    return (rng.randn(B, t, N, D) * 2).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the featurizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_fft", [True, False])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_featurize_clip_matches_jax_and_numpy(rng, use_fft, lead):
    raw = (rng.randn(*lead, N, 4 * FREQUENCY + 37) * 20).astype(np.float32)
    raw[..., 2, :FREQUENCY] = 0.0  # a silent window: the exact-zero floor
    got = featurize_clip(torch.from_numpy(raw), 1, FREQUENCY, use_fft)
    want = np.asarray(jax_featurize(jnp.asarray(raw), 1, FREQUENCY, use_fft))
    assert got.shape == want.shape == lead + (4, N, 100 if use_fft else 200)
    assert got.dtype == torch.float32
    _close(got, want, FEAT_ATOL)
    flat = raw.reshape(-1, N, raw.shape[-1])
    oracle = np.stack([featurize_clip_np(c.astype(np.float64), 1, FREQUENCY,
                                         use_fft) for c in flat])
    _close(got.reshape(oracle.shape), oracle, FEAT_ATOL)
    if use_fft:
        assert float(got[..., 0, 2, :].max()) == pytest.approx(np.log(1e-8))


# ---------------------------------------------------------------------------
# the tails
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph_type,reflect_invariant", [
    ("individual", False), ("combined", False), ("combined", True)])
@pytest.mark.parametrize("augment", [False, True])
def test_features_match_jax(rng, dist_pkl, graph_type, reflect_invariant,
                            augment):
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment, reflect_invariant)
    feats = _feats(rng)
    key = jax.random.PRNGKey(7)
    jx, jsup = jpipe.features(jnp.asarray(feats), key, True)
    draws = _jax_draws(key, B) if augment else None
    tx, tsup = tpipe.features(torch.from_numpy(feats), training=True,
                              draws=draws)
    _close(tx, jx, TAIL_ATOL)
    assert tsup.shape == jsup.shape
    _close(tsup, jsup, TAIL_ATOL)
    literal = augment and not (graph_type == "combined" and reflect_invariant)
    if graph_type == "combined":
        # per-clip (S, B, N, N) only under the literal reflection
        assert tsup.ndim == (4 if literal else 3)
    if literal:
        # both reflection branches ran (the key's draws)
        assert 0 < int(draws[0].sum()) < B
        if graph_type == "combined":
            chosen = torch.where(draws[0][None, :, None, None],
                                 tpipe.dist_supports_swapped[:, None],
                                 tpipe.dist_supports[:, None])
            assert torch.equal(tsup, chosen)


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
@pytest.mark.parametrize("augment", [False, True])
def test_ssl_features_match_jax(rng, dist_pkl, graph_type, augment):
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment)
    fx, fy = _feats(rng), _feats(rng, t=3)
    key = jax.random.PRNGKey(11)
    want = jpipe.ssl_features(jnp.asarray(fx), jnp.asarray(fy), key, True)
    got = tpipe.ssl_features(torch.from_numpy(fx), torch.from_numpy(fy),
                             training=True,
                             draws=_jax_draws(key, B) if augment else None)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, TAIL_ATOL)


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
def test_raw_pipeline_matches_jax(rng, dist_pkl, graph_type):
    """``__call__`` and ``ssl`` on raw clips, augmentation off: the FFT's
    rounding is the only difference."""
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment=False)
    raw = (rng.randn(B, N, T * FREQUENCY) * 20).astype(np.float32)
    raw_y = (rng.randn(B, N, 2 * FREQUENCY) * 20).astype(np.float32)
    key = jax.random.PRNGKey(0)
    for got, want in (
            (tpipe(torch.from_numpy(raw)), jpipe(jnp.asarray(raw), key,
                                                 False)),
            (tpipe.ssl(torch.from_numpy(raw), torch.from_numpy(raw_y)),
             jpipe.ssl(jnp.asarray(raw), jnp.asarray(raw_y), key, False))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _close(g, w, FEAT_ATOL)


def test_draws_come_from_the_generator(dist_pkl):
    _, tpipe = _pipes("combined", dist_pkl)
    a = tpipe.draw(64, torch.Generator().manual_seed(1))
    b = tpipe.draw(64, torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.bool and a[1].dtype == torch.float32
    assert 0 < int(a[0].sum()) < 64
    assert float(a[1].min()) >= 0.8 and float(a[1].max()) < 1.2
    # eval (training=False) draws nothing
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    feats = torch.randn(4, T, N, D)
    tpipe.features(feats, gen, training=False)
    assert torch.equal(gen.get_state(), state)
    x, _ = tpipe.features(feats, gen, training=True)
    assert not torch.equal(gen.get_state(), state) and x.shape == feats.shape


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
def test_bf16_storage_within_bf16_tolerance_of_jax_f32(rng, dist_pkl,
                                                       graph_type):
    """A bf16 cache's features: augment and standardize in bf16 (the JAX
    order), the correlation graph from their float32 upcast."""
    jpipe, tpipe = _pipes(graph_type, dist_pkl)
    feats = _feats(rng)
    key = jax.random.PRNGKey(7)
    jx, jsup = jpipe.features(jnp.asarray(feats), key, True)
    tx, tsup = tpipe.features(torch.from_numpy(feats).bfloat16(),
                              training=True, draws=_jax_draws(key, B))
    assert tx.dtype == torch.bfloat16 and tsup.dtype == torch.float32
    jx = np.asarray(jx)
    assert np.abs(tx.float().numpy() - jx).max() / np.abs(jx).max() <= 2e-2
    if graph_type == "combined":
        _close(tsup, jsup, TAIL_ATOL)


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
@pytest.mark.parametrize("augment", [False, True])
def test_bf16_storage_supports_match_rounded_f32(rng, dist_pkl, graph_type,
                                                 augment):
    """The supports of bf16-stored features (``features`` and
    ``ssl_features``, the JAX key's draws): exactly the port's float32
    pipeline on the same features rounded to bf16 and upcast, and within
    1e-5 of JAX's pipeline on those rounded features. (The graph is built
    from the float32 upcast, so a bf16 input can break a top-3 tie
    otherwise than its unrounded float32 original: that is the
    reference.)"""
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment)
    fx, fy = _feats(rng), _feats(rng, t=3)
    bx, by = (torch.from_numpy(f).bfloat16() for f in (fx, fy))
    rx, ry = bx.float(), by.float()
    key = jax.random.PRNGKey(13)
    draws = _jax_draws(key, B) if augment else None
    got = [tpipe.features(bx, training=True, draws=draws)[1],
           tpipe.ssl_features(bx, by, training=True, draws=draws)[2]]
    same = [tpipe.features(rx, training=True, draws=draws)[1],
            tpipe.ssl_features(rx, ry, training=True, draws=draws)[2]]
    want = [jpipe.features(jnp.asarray(rx.numpy()), key, True)[1],
            jpipe.ssl_features(jnp.asarray(rx.numpy()),
                               jnp.asarray(ry.numpy()), key, True)[2]]
    for g, s, w in zip(got, same, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, s)
        _close(g, w, TAIL_ATOL)


def test_classification_tail_waits_for_its_slice(rng, dist_pkl):
    """The classification tail, once a stub, at full lengths is the
    standard tail on the same draws (tests/test_torch_classification.py
    holds it against JAX's at mixed lengths)."""
    for graph_type in ("combined", "individual"):
        _, tpipe = _pipes(graph_type, dist_pkl)
        feats = torch.from_numpy(_feats(rng))
        draws = tpipe.draw(B, torch.Generator().manual_seed(1))
        got = tpipe.classification_features(
            feats, torch.full((B,), T), training=True, draws=draws)
        want = tpipe.features(feats, training=True, draws=draws)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# reflect_invariant and the model
# ---------------------------------------------------------------------------


def test_reflect_invariant_gives_the_unreflected_loss(rng, dist_pkl):
    """JAX ``test_reflect_invariant_fast_path_exact`` on the port: with the
    swapped graph the TRUE permutation P·A·Pᵀ, reflecting clip and graph
    (literal) and skipping both (reflect_invariant) give the same loss and
    gradients at dropout 0, from the same generator draws."""
    from eeg_gnn_tpu_torch.graphs.distance import load_distance_adjacency

    cfg = ExperimentConfig(do_train=True, graph_type="combined",
                           num_rnn_layers=1, rnn_units=8, input_dim=D,
                           max_diffusion_step=1, use_fft=True,
                           dropout=0.0).finalize()
    adj = load_distance_adjacency(dist_pkl)
    perm = tdp.reflection_permutation(N)
    slab = lambda a: torch.from_numpy(np.stack(compute_supports(
        a, cfg.filter_type)))
    raw = torch.from_numpy(rng.randn(B, N, T * FREQUENCY)
                           .astype(np.float32))
    batch = {"raw": raw, "y": torch.from_numpy(
        rng.randint(0, 2, B).astype(np.float32)),
        "seq_lengths": torch.full((B,), T)}
    model = build_model(cfg, torch.Generator().manual_seed(0)).train()
    out = {}
    for mode in (False, True):
        pipe = tdp.DevicePipeline(
            time_step_size=1, use_fft=True, graph_type="combined",
            filter_type=cfg.filter_type, top_k=None, mean=0.0, std=1.0,
            augment=True, node_perm=torch.from_numpy(perm),
            dist_supports=slab(adj), dist_supports_swapped=slab(
                adj[perm][:, perm]), reflect_invariant=mode)
        model.zero_grad()
        loss, _ = supervised_loss_fn(model, "detection", pipe)(
            batch, torch.Generator().manual_seed(11))
        loss.backward()
        out[mode] = (float(loss.detach()), [p.grad.clone() for p in
                                   model.parameters()])
    # the generator reflected some clips: the literal path did permute
    reflect, _ = pipe.draw(B, torch.Generator().manual_seed(11))
    assert 0 < int(reflect.sum()) < B
    assert out[True][0] == pytest.approx(out[False][0], rel=2e-5)
    for a, b in zip(out[False][1], out[True][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# Predictor's raw front door
# ---------------------------------------------------------------------------


def _predictors(graph_type, dist_pkl, **extra):
    kw = dict(graph_type=graph_type, max_seq_len=T, num_rnn_layers=2,
              rnn_units=16, max_diffusion_step=2, input_dim=D,
              test_batch_size=4, use_fft=True)
    jcfg = JaxConfig(do_train=True, **kw).finalize()
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment=False)
    cfg = ExperimentConfig(**kw, **extra).finalize()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return (JaxPredictor(jcfg, params, pipeline=jpipe),
            Predictor(cfg, sd, device="cpu", pipeline=tpipe))


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
def test_predict_proba_raw_matches_jax(rng, dist_pkl, graph_type):
    """n=7 clips at batch 4: the last chunk pads."""
    jpred, tpred = _predictors(graph_type, dist_pkl)
    raw = (rng.randn(7, N, T * FREQUENCY) * 20).astype(np.float32)
    lens = rng.randint(1, T + 1, size=7)
    for args in ((raw,), (raw, lens)):
        got, want = tpred.predict_proba_raw(*args), \
            jpred.predict_proba_raw(*args)
        assert got.shape == (7,) and np.all((got >= 0) & (got <= 1))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_predict_proba_raw_bf16_within_tolerance(rng, dist_pkl):
    jpred, tpred = _predictors("combined", dist_pkl, dtype="bfloat16")
    raw = (rng.randn(7, N, T * FREQUENCY) * 20).astype(np.float32)
    got, want = tpred.predict_proba_raw(raw), jpred.predict_proba_raw(raw)
    assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


def test_predict_proba_takes_the_pipelines_distance_supports(rng, dist_pkl):
    """Combined graph, no supports given: the distance graph's, broadcast
    over the batch (JAX ``_default_supports``)."""
    jpred, tpred = _predictors("combined", dist_pkl)
    x = rng.randn(5, T, N, D).astype(np.float32)
    got, want = tpred.predict_proba(x), jpred.predict_proba(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    sup = tpred.pipeline.dist_supports.numpy()
    explicit = tpred.predict_proba(
        x, supports=np.broadcast_to(sup[:, None], (1, 5, N, N)))
    np.testing.assert_allclose(got, explicit, rtol=1e-6, atol=1e-7)
    _, ind = _predictors("individual", dist_pkl)
    with pytest.raises(ValueError, match="supports required"):
        ind.predict_proba(x)
    with pytest.raises(ValueError, match="pipeline="):
        Predictor(ind.cfg, ind.model.state_dict(),
                  device="cpu").predict_proba_raw(x)
