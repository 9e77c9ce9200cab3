"""The port's device-resident dataset caches against the JAX package's, on
the CPU: index plans (resident and rotating) from the same RandomState,
``fits_in_hbm``, the rotating geometry (JAX's empty trailing shard, the
port's clamp), cached eval against streaming eval (detection and SSL),
rotating eval against resident eval, the epoch plans both cache kinds
hand the trainer, and the cached, epoch and multi-step train steps
against sequential ``TrainStep`` calls.

Tolerances: plans, geometry and budgets exactly; evaluations rtol 1e-5
(shared and per-clip supports sum in another order); the step variants
exactly (they are loops over the same ``TrainStep``).
"""

import logging

import numpy as np
import pytest
import torch

from eeg_gnn_tpu.data import device_cache as jdc
from eeg_gnn_tpu.data import rotating_cache as jrc
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.data import device_cache as tdc
from eeg_gnn_tpu_torch.data import rotating_cache as trc
from eeg_gnn_tpu_torch.data.datasets import (
    load_dataset_detection,
    load_dataset_ssl,
)
from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.train import step as tstep
from eeg_gnn_tpu_torch.train.trainer import Trainer

SSL = "SS pre-training"
CLIP, T_OUT = 12, 4
N, D = 19, 100


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    signals = {}
    p = make_synthetic_corpus(str(tmp_path_factory.mktemp("cache")),
                              num_files=4, file_seconds=96, clip_len=CLIP,
                              seed=0, signals=signals)
    return p, signals


def _cfg(task, graph_type, **kw):
    base = dict(do_train=True, task=task, graph_type=graph_type,
                max_seq_len=CLIP, output_seq_len=T_OUT, num_rnn_layers=1,
                rnn_units=16, max_diffusion_step=1, train_batch_size=4,
                test_batch_size=8, num_epochs=2, use_fft=True,
                num_workers=1)
    if task == SSL:
        base["metric_name"] = "loss"
    base.update(kw)
    return ExperimentConfig(**base).finalize()


def _data(corpus, cfg, plain=False):
    """(loaders, datasets, scaler): featurized loaders, or plain datasets
    for a cache (no augmentation, no standardization, no graph)."""
    p, signals = corpus
    kw = dict(input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
              train_batch_size=cfg.train_batch_size,
              test_batch_size=cfg.test_batch_size, time_step_size=1,
              standardize=not plain, num_workers=1, augmentation=False,
              adj_mat_dir=None if plain else p["adj_mat_dir"],
              graph_type=None if plain else cfg.graph_type, top_k=3,
              filter_type=cfg.filter_type, use_fft=True,
              marker_dir=p["marker_dir"], signals=signals,
              build_loaders=not plain)
    if cfg.task == SSL:
        return load_dataset_ssl(input_len=CLIP, output_len=T_OUT, **kw)
    return load_dataset_detection(max_seq_len=CLIP, seed=123, **kw)


class _NullWriter:
    def add_scalar(self, *args, **kwargs):
        pass


def _trainer(corpus, cfg, caches=None, seed=0):
    loaders, _, scaler = _data(corpus, cfg)
    pipe = make_device_pipeline(
        graph_type=cfg.graph_type, filter_type=cfg.filter_type, top_k=3,
        use_fft=True, time_step_size=1, scaler=scaler, augment=False,
        adj_mat_dir=corpus[0]["adj_mat_dir"], device="cpu")
    model = build_model(cfg, torch.Generator().manual_seed(seed))
    return Trainer(cfg, loaders, scaler, logging.getLogger("cache_test"),
                   _NullWriter(), model, device="cpu",
                   input_pipeline=pipe if caches else None,
                   device_caches=caches), pipe


def _build(corpus, cfg, split, rotating=False, **kw):
    _, plain, _ = _data(corpus, cfg, plain=True)
    ds = plain[split]
    if rotating:
        kind = "ssl" if cfg.task == SSL else "detection"
        return trc.build_rotating_cache(ds, CLIP, kind, device="cpu", **kw)
    if cfg.task == SSL:
        return tdc.build_ssl_cache(ds, CLIP, device="cpu", **kw)
    return tdc.build_detection_cache(ds, CLIP, device="cpu", **kw)


# ---------------------------------------------------------------------------
# plans, budgets, geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bsz", [(10, 4), (12, 4), (3, 8), (37, 5)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_index_plans_equal_jax(n, bsz, shuffle):
    feats = np.zeros((n, 2, 3, 4), np.float32)
    labels = np.arange(n, dtype=np.float32)
    jax_cache = jdc.DeviceDatasetCache(feats, labels, 2)
    port = tdc.DeviceDatasetCache(feats, labels, 2, device="cpu")
    j_rng, t_rng = np.random.RandomState(123), np.random.RandomState(123)
    for _ in range(3):  # consecutive epochs draw from one RandomState
        for a, b in zip(port.epoch_plan(bsz, shuffle, t_rng),
                        jax_cache.epoch_plan(bsz, shuffle, j_rng)):
            np.testing.assert_array_equal(a, b)
    for drop_last in (False, True):
        got = list(port.epoch_index_batches(bsz, shuffle, t_rng, drop_last))
        want = list(jax_cache.epoch_index_batches(bsz, shuffle, j_rng,
                                                  drop_last))
        assert len(got) == len(want)
        for (ia, va), (ib, vb) in zip(got, want):
            np.testing.assert_array_equal(ia, ib)
            assert va == vb


@pytest.mark.parametrize("n,budget,min_shards", [(37, 20_000, 2),
                                                 (40, 7_000, 2),
                                                 (12, 10 ** 9, 3)])
def test_rotating_plans_equal_jax(n, budget, min_shards):
    feats = np.zeros((n, 2, 3, 4), np.float32)  # 96 B a clip
    labels = np.arange(n, dtype=np.float32)
    jax_cache = jrc.RotatingDeviceCache(feats, labels, 2,
                                        budget_bytes=budget,
                                        min_shards=min_shards)
    port = trc.RotatingDeviceCache(feats, labels, 2, budget_bytes=budget,
                                   min_shards=min_shards, device="cpu")
    assert (port.num_shards, port.shard_rows, port.clip_bytes) == \
        (jax_cache.num_shards, jax_cache.shard_rows, jax_cache.clip_bytes)
    assert port.num_shards >= 2
    j_rng, t_rng = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        order = port.epoch_shard_order(t_rng)
        np.testing.assert_array_equal(order,
                                      jax_cache.epoch_shard_order(j_rng))
        seen = []
        for sid in order:
            got = port.shard_plan(sid, 4, True, t_rng)
            want = jax_cache.shard_plan(sid, 4, True, j_rng)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            assert port.shard_labels(sid).tolist() == \
                jax_cache.shard_labels(sid).tolist()
            assert port.shard_names(sid) == jax_cache.shard_names(sid)
            perm, valid = got
            for k, v in enumerate(valid):
                seen.extend(port.shard_labels(sid)[perm[k * 4:k * 4 + v]])
        # every clip once an epoch
        assert sorted(seen) == list(range(n))
    assert port.nbytes_resident() == jax_cache.nbytes_resident()


@pytest.mark.parametrize("rotating", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_plans_follow_jax_trainer(rotating, shuffle):
    """The plans a cache hands the trainer (``epoch_plans``) over two
    epochs: the rows, valid counts, labels and names the JAX trainer draws
    from the same RandomState (resident: ``epoch_plan``; rotating: the
    shard order, then each shard's plan), and each plan's x holding those
    rows."""
    n, bsz = 37, 4
    feats = np.arange(n * 24, dtype=np.float32).reshape(n, 2, 3, 4)
    labels = np.arange(n, dtype=np.float32)
    names = [f"clip{i}" for i in range(n)]
    if rotating:
        kw = dict(budget_bytes=20_000, names=names)
        port = trc.RotatingDeviceCache(feats, labels, 2, device="cpu", **kw)
        jax_cache = jrc.RotatingDeviceCache(feats, labels, 2, **kw)
        assert port.num_shards >= 2
    else:
        port = tdc.DeviceDatasetCache(feats, labels, 2, names=names,
                                      device="cpu")
        jax_cache = jdc.DeviceDatasetCache(feats, labels, 2, names=names)
    j_rng, t_rng = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(2):
        if rotating:
            order = (jax_cache.epoch_shard_order(j_rng) if shuffle
                     else range(jax_cache.num_shards))
            want = [(sid * jax_cache.shard_rows, *jax_cache.shard_plan(
                sid, bsz, shuffle, j_rng), jax_cache.shard_labels(sid),
                jax_cache.shard_names(sid)) for sid in order]
        else:
            want = [(0, *jax_cache.epoch_plan(bsz, shuffle, j_rng), labels,
                     names)]
        got = list(port.epoch_plans(bsz, shuffle, t_rng))
        assert len(got) == len(want)
        for plan, (lo, perm, valid, w_labels, w_names) in zip(got, want):
            np.testing.assert_array_equal(plan.perm, perm)
            np.testing.assert_array_equal(plan.valid, valid)
            np.testing.assert_array_equal(plan.labels, w_labels)
            assert list(plan.names) == list(w_names)
            rows = torch.from_numpy(perm[:int(valid.sum())].astype(np.int64))
            torch.testing.assert_close(
                plan.x[rows], torch.from_numpy(feats[lo + rows.numpy()]))
    if rotating:
        assert port.resident() == 0  # the epoch's slabs are freed


def test_fits_in_hbm_matches_jax():
    for args in [(4096, 60, 19, 100), (10_000, 60, 19, 100), (1, 1, 1, 1)]:
        for dtype in ("bfloat16", "float32"):
            for budget in (2 ** 30, 12 * 2 ** 30):
                for t_out in (0, 12):
                    kw = dict(storage_dtype=dtype, budget_bytes=budget,
                              t_out=t_out)
                    assert tdc.fits_in_hbm(*args, **kw) == \
                        jdc.fits_in_hbm(*args, **kw)
    # the flagship split: 4096 clips of (60, 19, 100) in bf16 = 0.93 GB
    assert tdc.fits_in_hbm(4096, 60, 19, 100, "bfloat16", 2 ** 30)
    assert not tdc.fits_in_hbm(4096, 60, 19, 100, "float32", 2 ** 30)
    assert tdc.fits_in_hbm(4096, 60, 19, 100, "bfloat16", 2 ** 30 // 2,
                           num_devices=2)


def test_rotating_geometry_clamps_the_empty_trailing_shard():
    """JAX ``rotating_geometry`` (``rotating_cache.py:48``, ADVICE.md): with
    8 clips over a data axis of 8, ``min_shards=2`` and rows rounded to 8
    leave shard 1 with no row; likewise 5 clips in at least 4 shards of 2.
    The port clamps the count; every shard has rows, all clips covered."""
    big = 10 ** 9
    for n, p, min_shards, jax_geom, port_geom in (
            (8, 8, 2, (2, 8), (1, 8)), (5, 1, 4, (4, 2), (3, 2))):
        assert jrc.rotating_geometry(n, 100, big, p, min_shards) == jax_geom
        shards, rows = jax_geom
        assert n - (shards - 1) * rows <= 0  # JAX's last shard is empty
        assert trc.rotating_geometry(n, 100, big, p, min_shards) == \
            port_geom
    for n in range(1, 41):
        for p in (1, 2, 4, 8):
            for min_shards in (1, 2, 3, 5):
                for budget in (300, 3_000, big):
                    shards, rows = trc.rotating_geometry(n, 100, budget, p,
                                                         min_shards)
                    assert rows % p == 0
                    assert (shards - 1) * rows < n <= shards * rows
                    want = jrc.rotating_geometry(n, 100, budget, p,
                                                 min_shards)
                    if (want[0] - 1) * want[1] < n:  # JAX had no empty one
                        assert (shards, rows) == want


def _jax_blocks(arr):
    """A JAX array sharded over a data mesh, device block by block."""
    return [np.asarray(sh.data) for sh in
            sorted(arr.addressable_shards, key=lambda sh: sh.index[0].start)]


def test_unported_cache_paths_raise():
    """The caches' mesh paths are ported: over a data:2 mesh, rank r holds
    the block (resident) or stripes (rotating) that device r of the JAX
    package's single-process data:2 mesh holds. What still raises is a
    mesh axis other than data and graph, and a striped cache's reads by
    global row (shard labels and names, whole-split plans)."""
    from eeg_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from eeg_gnn_tpu_torch.parallel.mesh import Mesh, check_axes

    import jax

    jmesh = jax_make_mesh("data:2", jax.devices()[:2])
    feats = np.arange(5 * 2 * 3 * 4, dtype=np.float32).reshape(5, 2, 3, 4)
    labels = np.arange(5, dtype=np.float32)
    jres = jdc.DeviceDatasetCache(feats, labels, 2, mesh=jmesh)
    jrot = jrc.RotatingDeviceCache(feats, labels, 2, budget_bytes=10 ** 6,
                                   min_shards=2, mesh=jmesh)
    for rank in (0, 1):
        mesh = Mesh(("data",), (2,), rank, 2, torch.device("cpu"), "gloo")
        res = tdc.DeviceDatasetCache(feats, labels, 2, mesh=mesh,
                                     device="cpu")
        np.testing.assert_array_equal(res.x.numpy(),
                                      _jax_blocks(jres.x)[rank])
        np.testing.assert_array_equal(res.y.numpy(),
                                      _jax_blocks(jres.y)[rank])
        with pytest.raises(ValueError, match="mesh_epoch_plan"):
            next(res.epoch_plans(4, False, np.random.RandomState(0)))
        rot = trc.RotatingDeviceCache(feats, labels, 2, budget_bytes=10 ** 6,
                                      min_shards=2, mesh=mesh, device="cpu")
        assert (rot.num_shards, rot.shard_rows) == (jrot.num_shards,
                                                    jrot.shard_rows)
        per = rot.shard_rows // 2
        for sid in range(rot.num_shards):  # real rows (pads are masked)
            real = max(0, min(per, 5 - sid * rot.shard_rows - rank * per))
            np.testing.assert_array_equal(
                rot.prefetch(sid).ready().x.numpy()[:real],
                _jax_blocks(jrot.prefetch(sid)["x"])[rank][:real])
        for read in (lambda: rot.shard_labels(0), lambda: rot.shard_names(0),
                     lambda: next(rot.epoch_plans(
                         4, False, np.random.RandomState(0)))):
            with pytest.raises(ValueError, match="stripes"):
                read()
    check_axes(("data", "graph"))  # the graph axis is ported
    with pytest.raises(ValueError, match="unknown mesh axis"):
        check_axes(("data", "model"))


def test_caches_store_in_the_storage_dtype():
    rng = np.random.RandomState(0)
    feats = rng.randn(5, 2, 3, 4).astype(np.float32)
    ys = rng.randn(5, 1, 3, 4).astype(np.float32)
    for dtype, want in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        c = tdc.DeviceDatasetCache(feats, ys, 2, storage_dtype=dtype,
                                   device="cpu")
        assert c.x.dtype == c.y.dtype == want
        assert c.nbytes() == (5 * 24 + 5 * 12) * (2 if want ==
                                                   torch.bfloat16 else 4)
        torch.testing.assert_close(c.x, torch.from_numpy(feats).to(want))
        r = trc.RotatingDeviceCache(feats, ys, 2, storage_dtype=dtype,
                                    device="cpu")
        slab = r.prefetch(r.num_shards - 1).ready()
        lo = (r.num_shards - 1) * r.shard_rows
        torch.testing.assert_close(slab.x, torch.from_numpy(feats[lo:]).to(
            want))
    labels = tdc.DeviceDatasetCache(feats, np.arange(5), 2,
                                    storage_dtype="bfloat16", device="cpu")
    assert labels.y.dtype == torch.float32  # labels stay float32
    # a plan batch: only its valid rows are gathered
    batch = labels.device_batch(np.array([3, 1, 3, 3], np.int32), 2)
    assert batch["idx"].tolist() == [3, 1] and batch["seq_len"] == 2
    assert batch["cache_x"] is labels.x and batch["cache_y"] is labels.y


# ---------------------------------------------------------------------------
# evaluation through the caches
# ---------------------------------------------------------------------------


def _results_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("task,graph_type", [("detection", "combined"),
                                             ("detection", "individual"),
                                             (SSL, "combined"),
                                             (SSL, "individual")])
def test_cached_eval_matches_streaming(corpus, task, graph_type):
    """The same parameters on the dev split: the cache's gather and device
    tail against the host loader's features and supports."""
    cfg = _cfg(task, graph_type)
    stream, _ = _trainer(corpus, cfg)
    cached, _ = _trainer(corpus, cfg, {"dev": _build(corpus, cfg, "dev")})
    _results_close(cached.evaluate("dev"), stream.evaluate("dev"))
    if task == "detection":
        _results_close(cached.evaluate("dev", is_test=True),
                       stream.evaluate("dev", is_test=True))


@pytest.mark.parametrize("task", ["detection", SSL])
def test_rotating_eval_matches_resident(corpus, task):
    cfg = _cfg(task, "combined")
    resident, _ = _trainer(corpus, cfg, {"dev": _build(corpus, cfg, "dev")})
    rot = _build(corpus, cfg, "dev", rotating=True, budget_bytes=0,
                 min_shards=3)
    assert rot.num_shards >= 3 and rot.shard_rows >= 1
    rotating, _ = _trainer(corpus, cfg, {"dev": rot})
    _results_close(rotating.evaluate("dev"), resident.evaluate("dev"))
    assert rot.resident() == 0  # eval freed its slabs


def test_rotating_training_keeps_two_slabs_and_visits_each_clip(corpus,
                                                                 tmp_path):
    cfg = _cfg("detection", "combined", num_epochs=1)
    rot = _build(corpus, cfg, "train", rotating=True, budget_bytes=0,
                 min_shards=4)
    trainer, _ = _trainer(corpus, cfg, {"train": rot})
    live, rows = [], []
    prefetch = rot.prefetch
    run = trainer.cached_epoch_step

    def counting_prefetch(shard):
        slab = prefetch(shard)
        live.append(rot.resident())
        return slab

    def recording_run(x, y, perm, valid_vec, seen, seq=None):
        rows.extend(int(y[i]) for k, v in enumerate(valid_vec)
                    for i in perm[k * 4:k * 4 + v])
        return run(x, y, perm, valid_vec, seen, seq)

    rot.prefetch = counting_prefetch
    trainer.cached_epoch_step = recording_run
    trainer.train(str(tmp_path))
    assert len(live) == rot.num_shards and max(live) <= 2
    labels = rot._labels_host
    assert sorted(rows) == sorted(int(v) for v in labels)
    assert rot.resident() == 0


# ---------------------------------------------------------------------------
# the step variants
# ---------------------------------------------------------------------------


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("task", ["detection", SSL])
def test_cached_and_fused_steps_equal_sequential_calls(corpus, task):
    """One plan of K=5 steps of 2 clips (the last one short):
    make_cached_train_step, make_cached_epoch_step over the plan, and
    make_multi_train_step on the same rows as host batches, each from the
    same weights and generator, against K sequential TrainStep calls."""
    extra = dict(use_curriculum_learning=True, cl_decay_steps=2) \
        if task == SSL else {}
    cfg = _cfg(task, "individual", **extra)
    cache = _build(corpus, cfg, "train")
    perm, valid = cache.epoch_plan(2, True, np.random.RandomState(1))
    perm, valid = perm[:10], valid[:5].copy()
    valid[-1] = 1
    idx = torch.from_numpy(perm.astype(np.int64))
    results = {}
    for mode in ("sequential", "cached", "epoch", "multi"):
        trainer, pipe = _trainer(corpus, cfg, {"train": cache})
        step = trainer.step
        seen = 100
        if mode == "sequential":
            losses = []
            for k, v in enumerate(valid):
                losses.append(step(tstep.cached_batch(
                    cache.x, cache.y, idx[k * 2:k * 2 + v], CLIP),
                    batches_seen=seen))
                seen += int(v)
            losses = torch.stack(losses)
        elif mode == "cached":
            run = tstep.make_cached_train_step(step, CLIP, 2)
            losses = torch.zeros(5)
            counter = 0
            for _ in range(5):
                counter, seen = run(cache.x, cache.y, idx, valid, counter,
                                    seen, losses)
            assert (counter, seen) == (5, 100 + int(valid.sum()))
        elif mode == "epoch":
            run = tstep.make_cached_epoch_step(step, CLIP, 2)
            losses = run(cache.x, cache.y, idx, valid, seen)
        else:
            host = []
            for k, v in enumerate(valid):
                rows = idx[k * 2:k * 2 + v]
                feats = cache.x[rows]
                fy = cache.y[rows]
                if task == SSL:
                    x, y, sup = pipe.ssl_features(feats, fy)
                else:
                    (x, sup), y = pipe.features(feats), fy
                host.append({"x": x.numpy(), "y": y.numpy(),
                             "seq_lengths": np.full(int(v), CLIP),
                             "supports": sup.numpy()})
            losses = tstep.make_multi_train_step(step)(host,
                                                       batches_seen=seen)
        assert losses.shape == (5,)
        results[mode] = (losses, _params(step.model))
    want_losses, want_params = results["sequential"]
    for mode in ("cached", "epoch", "multi"):
        losses, params = results[mode]
        torch.testing.assert_close(losses, want_losses, rtol=0, atol=0)
        for a, b in zip(params, want_params):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mesh_cached_step_waits_for_scale_out():
    """The mesh cached step is ported (its two-rank run against JAX:
    tests/test_torch_dp_step.py); it needs a TrainStep with a mesh."""
    cfg = _cfg("detection", "combined")
    step = tstep.TrainStep(cfg, build_model(cfg), 1, device="cpu")
    with pytest.raises(ValueError, match="no mesh"):
        tstep.make_mesh_cached_train_step(step, 12, 4)
