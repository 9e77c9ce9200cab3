"""The data-parallel cases of ``tests/test_torch_dp_step.py``: the seeded
configurations and inputs that the port's ranks and the JAX mesh step
share, and the port's rank worker, which imports no JAX:

    python tests/torch_dp_cases.py RANK WORLD PORT OUT_DIR

forms a gloo group of WORLD ranks on the CPU (``tcp://127.0.0.1:PORT``),
runs every case through ``TrainStep(mesh=)`` on its rows of each global
batch, and writes ``OUT_DIR/rank{RANK}.npz``: each case's losses and its
state_dict after every step.
"""

import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N, T, D, H, T_OUT, B = 19, 4, 8, 8, 2, 4
STEPS, STEPS_PER_EPOCH, EPOCHS = 3, 2, 3  # the cosine LR moves at step 2
MEAN, STD = 0.25, 1.5
CACHE_CLIPS, PLAN_SEED = 7, 7
DC_TIME, DC_CLASSES, DC_B = 700, 4, 2  # the Dense-CNN's least plane (7 s)
CASES = ("detection", "classification", "ssl", "cached", "rotating",
         "densecnn")
# global valid rows of the host-batch cases: 1 of 4 leaves rank 1 (rows 2,
# 3) nothing but padding
VALID = {"detection": 1, "classification": 3, "ssl": 1, "densecnn": 1}


def cfg_kw(case):
    """The ExperimentConfig fields of a case (both packages')."""
    kw = dict(do_train=True, graph_type="combined", max_seq_len=T,
              num_rnn_layers=2, rnn_units=H, max_diffusion_step=2,
              input_dim=D, num_epochs=EPOCHS, train_batch_size=B,
              test_batch_size=B)
    if case == "classification":
        kw.update(task="classification", num_classes=4)
    elif case == "ssl":
        kw.update(task="SS pre-training", output_seq_len=T_OUT,
                  output_dim=D, metric_name="loss")
    elif case in ("cached", "rotating"):
        kw.update(num_rnn_layers=1, max_diffusion_step=1)
    elif case == "densecnn":
        kw = dict(model_name="densecnn", task="classification",
                  num_classes=DC_CLASSES, max_seq_len=DC_TIME // 100,
                  use_fft=True, do_train=True, input_dim=100,
                  num_epochs=EPOCHS, metric_name="F1", train_batch_size=DC_B)
    return kw


def padded(a, valid):
    """``a`` with its rows from ``valid`` on replaced by row 0, as the
    trainers pad a partial batch."""
    a = a.copy()
    a[valid:] = a[:1]
    return a


def host_batch(case):
    """The GLOBAL host batch of a host-batch case (numpy, padded)."""
    rng = np.random.RandomState(CASES.index(case))
    valid = VALID[case]
    if case == "densecnn":
        x = rng.randn(DC_B, DC_TIME, N)
        y = rng.randint(0, DC_CLASSES, size=DC_B)
        return {"x": padded(x, valid), "y": padded(y, valid),
                "seq_lengths": np.full((DC_B,), DC_TIME // 100),
                "valid": valid}
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    x = rng.randn(B, T, N, D).astype(np.float32)
    if case == "ssl":
        y = rng.randn(B, T_OUT, N, D).astype(np.float32)
        y[rng.rand(*y.shape) < 0.1] = 0.0  # masked entries
        return {"x": padded(x, valid), "y": padded(y, valid),
                "adjacency": padded(adj, valid), "valid": valid}
    y = (rng.randint(0, 2, size=B).astype(np.float32)
         if case == "detection" else rng.randint(0, 4, size=B))
    lens = rng.randint(1, T + 1, size=B)
    return {"x": padded(x, valid), "y": padded(y, valid),
            "seq_lengths": padded(lens, valid),
            "adjacency": padded(adj, valid), "valid": valid}


def cache_split():
    """(features (CACHE_CLIPS, T, N, D), labels) of the cached cases."""
    rng = np.random.RandomState(11)
    return (rng.randn(CACHE_CLIPS, T, N, D).astype(np.float32),
            rng.randint(0, 2, size=CACHE_CLIPS).astype(np.float32))


def rotating_budget():
    """A budget that cuts the cached split into 2 shards of 4 rows over 2
    ranks (stripes of 2), the last shard with one row of padding."""
    return 3 * T * N * D * 4 * 2


def write_adjacency(path):
    """A distance-graph pickle (the synthetic corpus's layout) for the
    cached cases' combined graph."""
    rng = np.random.RandomState(5)
    adj = np.abs(rng.rand(N, N)).astype(np.float32)
    adj = (adj + adj.T) / 2
    adj[adj < 0.5] = 0.0
    np.fill_diagonal(adj, 1.0)
    with open(path, "wb") as f:
        pickle.dump([[f"ch{i}" for i in range(N)],
                     {f"ch{i}": i for i in range(N)}, adj], f)


def init_model(case):
    """The port model every side starts from (the JAX side through
    ``io.params_to_jax``)."""
    import torch

    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.models.registry import build_model

    cfg = ExperimentConfig(**cfg_kw(case)).finalize()
    model = build_model(cfg, torch.Generator().manual_seed(
        3 + CASES.index(case)))
    return cfg, model.double() if case == "densecnn" else model


# ---------------------------------------------------------------------------
# the port's rank worker
# ---------------------------------------------------------------------------


def _snapshot(step):
    return {k: v.detach().numpy().copy()
            for k, v in step.model.state_dict().items()}


def _host_steps(case, mesh, step):
    b = host_batch(case)
    rows = mesh.rows(len(b["x"]))
    local = {k: (v if k == "valid" else v[rows]) for k, v in b.items()}
    out = []
    for i in range(STEPS):
        loss = step(local, batches_seen=i * b["valid"])
        out.append((float(loss), _snapshot(step)))
    return out


def _cached_steps(case, mesh, step):
    import torch

    from eeg_gnn_tpu_torch.data.device_cache import DeviceDatasetCache
    from eeg_gnn_tpu_torch.data.rotating_cache import RotatingDeviceCache
    from eeg_gnn_tpu_torch.parallel.distributed import global_put
    from eeg_gnn_tpu_torch.train.step import make_mesh_cached_train_step

    feats, labels = cache_split()
    rng = np.random.RandomState(PLAN_SEED)
    if case == "cached":
        cache = DeviceDatasetCache(feats, labels, T, mesh=mesh, device="cpu")
        plans = [(cache.x, cache.y) + cache.mesh_epoch_plan(
            B, mesh.world, True, rng)]
    else:
        cache = RotatingDeviceCache(feats, labels, T,
                                    budget_bytes=rotating_budget(),
                                    min_shards=2, mesh=mesh, device="cpu")
        plans = [(slab.x, slab.y, i, m) for slab, i, m
                 in cache.mesh_shard_plans(B, True, rng)]
    run = make_mesh_cached_train_step(step, T, B)
    out, seen = [], 0
    for x, y, idx_mat, mask_mat in plans:
        idx = global_put(idx_mat.astype(np.int64), mesh, axis=1)
        mask = global_put(mask_mat, mesh, axis=1)
        valid = mask_mat.sum(axis=1)
        losses = torch.zeros(len(valid))
        for k in range(len(valid)):
            _, seen = run(x, y, idx, mask, valid, k, seen, losses)
            out.append((float(losses[k]), _snapshot(step)))
    return out


def run_case(case, mesh, out_dir):
    import torch

    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.scaler import StandardScaler
    from eeg_gnn_tpu_torch.models import densecnn
    from eeg_gnn_tpu_torch.train import TrainStep

    densecnn.DROPOUT_RATE = 0.0  # JAX's dropout draws cannot be reproduced
    cfg, model = init_model(case)
    kw = {}
    if case == "ssl":
        kw = dict(mean=MEAN, std=STD)
    if case in ("cached", "rotating"):
        kw["input_pipeline"] = make_device_pipeline(
            graph_type="combined", filter_type=cfg.filter_type, top_k=3,
            use_fft=True, time_step_size=1,
            scaler=StandardScaler(MEAN, STD), augment=False,
            adj_mat_dir=os.path.join(out_dir, "adj.pkl"), device="cpu")
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, mesh=mesh,
                     generator=torch.Generator().manual_seed(0), **kw)
    if case in ("cached", "rotating"):
        return _cached_steps(case, mesh, step)
    return _host_steps(case, mesh, step)


def main(rank, world, port, out_dir):
    import torch

    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh

    torch.set_num_threads(2)
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
    mesh = make_mesh("data:-1")
    arrays = {}
    for case in CASES:
        for i, (loss, state) in enumerate(run_case(case, mesh, out_dir)):
            arrays[f"{case}/{i}/loss"] = np.float64(loss)
            arrays.update({f"{case}/{i}/{k}": v for k, v in state.items()})
    arrays["counts"] = np.asarray(
        [v for pair in distributed.counts().values() for v in pair])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
