"""The port's seizure-type classification slice against the JAX package on
the CPU: the variable-length clip, ``ClassificationDataset`` and
``load_dataset_classification`` (both graphs, augmentation on with the
same draws), the classifier's logits and every gradient at mixed
``seq_lengths``, dropout's rate and scaling, the device pipeline's
classification tail, and the classification caches (resident and
rotating) against the host loader. The CLI runs are in
``tests/test_torch_cli.py``.

Inputs come from a seed with numpy; sizes are small (2 layers x 8 units,
T <= 8; corpora of 12 s clips). Tolerances: clips, dataset items and
batches exactly (the same numpy arithmetic); logits and gradients 1e-5
of each tensor's largest magnitude (float32 summed in another order);
the tails 1e-5 absolute.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.data import clips as jclips
from eeg_gnn_tpu.data import datasets as jds
from eeg_gnn_tpu.data import device_pipeline as jdp
from eeg_gnn_tpu.data.synthetic import make_synthetic_corpus
from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.models import dcrnn as jdcrnn
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.data import clips as tclips
from eeg_gnn_tpu_torch.data import datasets as tds
from eeg_gnn_tpu_torch.data import device_cache as tdc
from eeg_gnn_tpu_torch.data import device_pipeline as tdp
from eeg_gnn_tpu_torch.data import rotating_cache as trc
from eeg_gnn_tpu_torch.data.scaler import StandardScaler
from eeg_gnn_tpu_torch.graphs import compute_supports_torch
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.models.dcgru import dropout
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.train.step import cached_batch, supervised_loss_fn

CLIP = 12
T, N, D, H, B, C = 8, 19, 12, 8, 6, 4
GRAD_TOL = 1e-5
TAIL_ATOL = 1e-5
FILTER = {"individual": "dual_random_walk", "combined": "laplacian"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 files x 96 s, 1-2 seizures each: clips of several lengths."""
    root = str(tmp_path_factory.mktemp("cls_corpus"))
    return make_synthetic_corpus(root, num_files=12, file_seconds=96,
                                 clip_len=CLIP, seed=1)


def _loader_kw(p, graph_type, augment=False, standardize=True):
    return dict(
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        train_batch_size=4, test_batch_size=5, max_seq_len=CLIP,
        time_step_size=1, standardize=standardize, num_workers=1,
        augmentation=augment, adj_mat_dir=p["adj_mat_dir"],
        graph_type=graph_type, top_k=3, filter_type=FILTER[graph_type],
        use_fft=True, marker_dir=p["marker_dir"])


def _assert_items_equal(got, want):
    """One sample tuple (x, y, seq_len, supports, adj, name), exactly."""
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1] == want[1] and got[2] == want[2] and got[5] == want[5]
    assert len(got[3]) == len(want[3])
    for s_got, s_want in zip(got[3], want[3]):
        np.testing.assert_array_equal(s_got, s_want)
    np.testing.assert_array_equal(got[4], want[4])


# ---------------------------------------------------------------------------
# clips, datasets, loaders
# ---------------------------------------------------------------------------


def test_classification_clips_match_jax(corpus):
    """Every seizure's clip, sliced from the h5 file and from the signal
    in memory; the lengths vary and include a clip cut short by the
    seizure's end."""
    _, sets, _ = tds.load_dataset_classification(
        build_loaders=False, **_loader_kw(corpus, "combined"))
    lens = set()
    for ds in sets.values():
        for edf_fn, _, idx in ds.file_tuples:
            edf = ds._lookup_edf(edf_fn)
            h5 = f"{corpus['input_dir']}/{edf_fn.split('.edf')[0]}.h5"
            want = jclips.slice_classification_clip(h5, edf, idx, 1, CLIP,
                                                    True)
            got = tclips.slice_classification_clip(h5, edf, idx, 1, CLIP,
                                                   True)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tclips.classification_clip(
                tclips.read_resampled_h5(h5),
                tclips.get_seizure_times(edf.split(".edf")[0]), idx, 1,
                CLIP, True), want)
            lens.add(want.shape[0])
    assert len(lens) > 1 and min(lens) < CLIP


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classification_dataset_matches_jax(corpus, graph_type, augment):
    """Items of each split, the train split augmented from equal draws:
    augment, standardize, then pad; the graph from the unpadded clip."""
    kw = _loader_kw(corpus, graph_type, augment)
    _, jsets, jscaler = jds.load_dataset_classification(build_loaders=False,
                                                        **kw)
    _, tsets, tscaler = tds.load_dataset_classification(build_loaders=False,
                                                        **kw)
    assert (tscaler.mean, tscaler.std) == (jscaler.mean, jscaler.std)
    for split in ("train", "dev", "test"):
        jset, tset = jsets[split], tsets[split]
        jset.rng, tset.rng = (np.random.RandomState(5),
                              np.random.RandomState(5))
        assert len(tset) == len(jset) > 0
        for i in range(len(tset)):
            _assert_items_equal(tset[i], jset[i])


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classification_loaders_match_jax(corpus, graph_type):
    """load_dataset_classification's batches, shuffled train split
    augmented from equal draws, one worker."""
    kw = _loader_kw(corpus, graph_type, augment=True)
    jloaders, _, _ = jds.load_dataset_classification(**kw)
    tloaders, _, _ = tds.load_dataset_classification(**kw)
    for split in ("train", "dev", "test"):
        jloaders[split].dataset.rng = np.random.RandomState(9)
        tloaders[split].dataset.rng = np.random.RandomState(9)
        jb, tb = list(jloaders[split]), list(tloaders[split])
        assert len(tb) == len(jb) > 0
        for got, want in zip(tb, jb):
            np.testing.assert_array_equal(got.x, want.x)
            np.testing.assert_array_equal(got.y, want.y)
            np.testing.assert_array_equal(got.seq_lengths, want.seq_lengths)
            np.testing.assert_array_equal(got.supports, want.supports)
            assert got.names == want.names


# ---------------------------------------------------------------------------
# the model: logits and gradients at mixed lengths, dropout
# ---------------------------------------------------------------------------


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("input_fusion", [True, False])
@pytest.mark.parametrize("recurrence", ["pallas", "stacked"])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classifier_matches_jax_at_mixed_lengths(graph_type, recurrence,
                                                 input_fusion):
    """Logits and every parameter's gradient under a seeded cotangent, at
    lengths that include 1 and T and clips whose padded tail is exactly
    zero, against JAX ``classification_apply`` and ``jax.grad`` through
    its stacked scan; the port's ``pallas`` recurrence is its kernels'
    plain versions here. Dropout 0 (the mask's stream is each
    package's)."""
    rng = np.random.RandomState(4)
    lens = np.array([1, T, 3, T, 5, 2])
    x = rng.randn(B, T, N, D).astype(np.float32)
    for b, n in enumerate(lens):
        if b % 2 == 0:
            x[b, n:] = 0.0
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    cot = rng.randn(B, C).astype(np.float32)
    cfg = ExperimentConfig(graph_type=graph_type, task="classification",
                           num_classes=C, max_seq_len=T, num_rnn_layers=2,
                           rnn_units=H, max_diffusion_step=2, input_dim=D,
                           recurrence=recurrence,
                           input_fusion=input_fusion).finalize()
    jcfg = jdcrnn.DCRNNConfig(
        input_dim=D, rnn_units=H, num_rnn_layers=2, max_diffusion_step=2,
        num_nodes=N, num_supports=cfg.num_supports, num_classes=C,
        recurrence="stacked")
    params = jdcrnn.init_classification_model(jax.random.PRNGKey(2), jcfg)
    sup = compute_supports_jnp(jnp.asarray(adj), cfg.filter_type)

    def jloss(p):
        logits = jdcrnn.classification_apply(
            jcfg, p, jnp.asarray(x), jnp.asarray(lens), sup)
        return jnp.sum(logits * cot), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    logits = model(torch.from_numpy(x), torch.from_numpy(lens),
                   compute_supports_torch(torch.from_numpy(adj),
                                          cfg.filter_type))
    (logits * torch.from_numpy(cot)).sum().backward()
    assert _norm_err(logits.detach(), jlogits) <= GRAD_TOL
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        assert _norm_err(p.grad, want[name]) <= GRAD_TOL, name


@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_dropout_rate_and_scaling_match_jax(rate):
    """The masks come from different streams: they agree in distribution.
    The kept share of 2**20 entries is within 5 standard deviations of
    1 - rate for both, and kept entries are x / (1 - rate) in both."""
    n = 2 ** 20
    x = np.random.RandomState(0).rand(n).astype(np.float32) + 0.5
    got = dropout(torch.from_numpy(x), rate, True,
                  torch.Generator().manual_seed(3)).numpy()
    want = np.asarray(jdcrnn._dropout(jnp.asarray(x), rate,
                                      jax.random.PRNGKey(3), True))
    sd = np.sqrt(rate * (1 - rate) / n)
    for out in (got, want):
        kept = out != 0
        assert abs(kept.mean() - (1 - rate)) < 5 * sd
        np.testing.assert_array_equal(out[kept],
                                      x[kept] / np.float32(1 - rate))
    np.testing.assert_array_equal(
        dropout(torch.from_numpy(x), rate, False).numpy(), x)


# ---------------------------------------------------------------------------
# the device pipeline's classification tail and the caches
# ---------------------------------------------------------------------------


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


def _pipes(graph_type, adj_mat_dir, augment, scaler):
    kw = dict(graph_type=graph_type, filter_type=FILTER[graph_type],
              top_k=3, use_fft=True, time_step_size=1, scaler=scaler,
              augment=augment, adj_mat_dir=adj_mat_dir)
    return (jdp.make_device_pipeline(**kw),
            tdp.make_device_pipeline(device="cpu", **kw))


@pytest.mark.parametrize("padding_val", [0.0, -1.5])
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classification_tail_matches_jax(dist_pkl, graph_type, augment,
                                         padding_val):
    """``classification_features`` on padded clips whose padding is not
    zero (the graph must still ignore it), lengths 1..T, the JAX key's
    draws fed in."""
    jpipe, tpipe = _pipes(graph_type, dist_pkl, augment,
                          StandardScaler(mean=np.float64(0.3),
                                         std=np.float64(2.0)))
    rng = np.random.RandomState(6)
    lens = np.array([1, T, 4, T - 1, 2, T])
    feats = (rng.randn(B, T, N, 100) * 2).astype(np.float32)
    for b, n in enumerate(lens):
        feats[b, n:] = 7.0
    key = jax.random.PRNGKey(11)
    jx, jsup = jpipe.classification_features(
        jnp.asarray(feats), jnp.asarray(lens), key, True, padding_val)
    draws = None
    if augment:
        k_ref, k_scale = jax.random.split(key)
        draws = (torch.from_numpy(np.array(
                     jax.random.bernoulli(k_ref, 0.5, (B,)))),
                 torch.from_numpy(np.array(jax.random.uniform(
                     k_scale, (B,), minval=0.8, maxval=1.2))))
    tx, tsup = tpipe.classification_features(
        torch.from_numpy(feats), torch.from_numpy(lens), training=True,
        draws=draws, padding_val=padding_val)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=TAIL_ATOL)
    for b, n in enumerate(lens):
        assert torch.all(tx[b, n:] == padding_val)
    assert tsup.shape == jsup.shape
    np.testing.assert_allclose(tsup.numpy(), np.asarray(jsup), rtol=0,
                               atol=TAIL_ATOL)


@pytest.mark.parametrize("kind", ["resident", "rotating"])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classification_caches_match_host_loader(corpus, graph_type, kind):
    """A cache of the plain (unaugmented, unstandardized) datasets, each
    split's plans gathered and run through the classification tail,
    gives the standardized host loader's x, lengths, labels and supports
    for every clip (the cache is built from the same clips: only the tail
    differs)."""
    _, plain, _ = tds.load_dataset_classification(
        build_loaders=False,
        **_loader_kw(corpus, graph_type, standardize=False)
        | dict(adj_mat_dir=None, graph_type=None))
    _, host, scaler = tds.load_dataset_classification(
        build_loaders=False, **_loader_kw(corpus, graph_type))
    _, pipe = _pipes(graph_type, corpus["adj_mat_dir"], False, scaler)
    for split in ("train", "dev", "test"):
        if kind == "resident":
            cache = tdc.build_classification_cache(plain[split], CLIP,
                                                   device="cpu")
        else:
            cache = trc.build_rotating_cache(plain[split], CLIP,
                                             "classification",
                                             budget_bytes=1, device="cpu")
            assert cache.num_shards == len(plain[split])
        want = {host[split][i][5]: host[split][i]
                for i in range(len(host[split]))}
        seen = []
        for plan in cache.epoch_plans(3, True, np.random.RandomState(0)):
            assert plan.seq is not None and plan.seq.dtype == torch.int64
            for k, valid in enumerate(plan.valid):
                rows = torch.from_numpy(
                    plan.perm[3 * k:3 * k + int(valid)].astype(np.int64))
                x, sup = pipe.classification_features(
                    plan.x[rows], plan.seq[rows])
                if sup.ndim == 3:  # the shared slab
                    sup = sup[:, None].expand(-1, len(rows), -1, -1)
                for j, r in enumerate(rows.tolist()):
                    item = want[plan.names[r]]
                    seen.append(plan.names[r])
                    np.testing.assert_allclose(x[j].numpy(), item[0],
                                               rtol=0, atol=TAIL_ATOL)
                    assert int(plan.seq[r]) == item[2]
                    assert plan.labels[r] == item[1]
                    np.testing.assert_allclose(
                        sup[:, j].numpy(), np.stack(item[3]), rtol=0,
                        atol=TAIL_ATOL)
        assert sorted(seen) == sorted(want)


def test_cached_classification_loss_takes_the_clips_lengths(corpus):
    """The cached step's loss path gathers each row's length: its loss
    and logits equal those of the host batch with ``seq_lengths``."""
    _, plain, _ = tds.load_dataset_classification(
        build_loaders=False,
        **_loader_kw(corpus, "combined", standardize=False)
        | dict(adj_mat_dir=None, graph_type=None))
    loaders, _, scaler = tds.load_dataset_classification(
        **_loader_kw(corpus, "combined"))
    _, pipe = _pipes("combined", corpus["adj_mat_dir"], False, scaler)
    cfg = ExperimentConfig(graph_type="combined", task="classification",
                           num_classes=C, max_seq_len=CLIP, rnn_units=H,
                           input_dim=100).finalize()
    model = build_model(cfg, torch.Generator().manual_seed(0)).eval()
    cache = tdc.build_classification_cache(plain["test"], CLIP,
                                           device="cpu")
    batch = next(iter(loaders["test"]))
    rows = torch.arange(len(batch))
    assert [cache.names[i] for i in rows] == batch.names
    assert len(set(batch.seq_lengths.tolist())) > 1
    loss_fn = supervised_loss_fn(model, "classification", pipe)
    with torch.no_grad():
        got = loss_fn(cached_batch(cache.x, cache.y, rows, CLIP, cache.seq))
        want = loss_fn({"x": torch.from_numpy(batch.x),
                        "y": torch.from_numpy(batch.y).long(),
                        "seq_lengths": torch.from_numpy(batch.seq_lengths),
                        "supports": torch.from_numpy(batch.supports)})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
