"""Entry points of the port (``__graft_entry__.py``'s counterpart).

- ``entry(device=None) -> (fn, example_args)``: the flagship detector's
  forward (Dist-DCRNN seizure detection, the paper's config: 2 DCGRU
  layers x 64, K=2, D=100, laplacian supports, the x-in encoder) at
  batch 8, T=12; ``fn(params, x, lengths, supports)`` takes a state_dict.
- ``dryrun_multichip(n)``: run by every rank of an n-rank process group
  (``parallel.distributed.initialize``): one train step of each sharded
  path on tiny shapes, (1) data-parallel detection on the combined graph,
  held against the same step on one rank, (2) the individual graph built
  from raw clips by the ``DevicePipeline``, (3) SSL pre-training, (3b) the
  row-sharded cached step, all on ``data:n``, and (4) the sparse DCGRU
  step whose diffusion is the ring SpMM, on ``graph:n``.

``python -m eeg_gnn_tpu_torch.entry [--ranks N] [--device cpu]`` runs the
forward, then starts N ranks on this host (a process each, default 8)
that run the dry run: NCCL when each rank has a card of its own,
otherwise gloo (``distributed.choose_backend``). Without ``--device cpu``
everything runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from eeg_gnn_tpu_torch.device import resolve_device

N_NODES, D_IN = 19, 100
RANK_TIMEOUT = 900  # s a rank of the dry run may take


def _flagship(batch: int, seq_len: int, device, num_layers: int = 2):
    """(model, (x, lengths, supports)) of the flagship detector on
    ``device``: weights from a seeded generator, inputs from a seeded
    numpy stream (the JAX package's draws)."""
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier, DCRNNConfig

    cfg = DCRNNConfig(input_dim=D_IN, rnn_units=64, num_rnn_layers=num_layers,
                      max_diffusion_step=2, num_nodes=N_NODES,
                      num_supports=1, num_classes=1, input_fusion=True)
    model = DCRNNClassifier(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, seq_len, N_NODES, D_IN).astype(
        np.float32)).to(device)
    lengths = torch.full((batch,), seq_len, dtype=torch.int64, device=device)
    adj = np.abs(rng.randn(batch, N_NODES, N_NODES)).astype(np.float32)
    supports = compute_supports_torch(torch.from_numpy(adj).to(device),
                                      "laplacian")
    return model.to(device).eval(), (x, lengths, supports)


def entry(device=None):
    """The flagship detector's eval forward on ``device`` (None: the
    card): ``(fn, (params, x, lengths, supports))``, ``fn(params, x,
    lengths, supports) -> (8, 1)`` logits, ``params`` a state_dict of the
    model's shapes."""
    dev = resolve_device(device, "entry")
    model, (x, lengths, supports) = _flagship(8, 12, dev)

    def fn(params, x, lengths, supports):
        with torch.inference_mode():
            return torch.func.functional_call(model, params,
                                              (x, lengths, supports))

    return fn, (dict(model.state_dict()), x, lengths, supports)


def _finite(loss, what: str) -> float:
    value = float(loss)
    if not np.isfinite(value):
        raise RuntimeError(f"dryrun_multichip: non-finite {what} loss "
                           f"{value}")
    return value


def dryrun_multichip(n_devices: int) -> None:
    """One train step of every sharded path over the n ranks of the
    process group (every rank calls it; see the module docstring). (1)
    holds the mesh step against the same step on one rank: loss rtol
    1e-4, parameters rtol 5e-4 / atol 1e-5. Raises on a failure."""
    import torch.distributed as dist

    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data.device_cache import DeviceDatasetCache
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.graphs.sparse import from_dense_batch
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier, DCRNNConfig
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
    from eeg_gnn_tpu_torch.parallel.edge_partition import partition_by_dest
    from eeg_gnn_tpu_torch.parallel.sparse_model import make_sparse_train_step
    from eeg_gnn_tpu_torch.train import TrainStep
    from eeg_gnn_tpu_torch.train.optim import make_optimizer
    from eeg_gnn_tpu_torch.train.step import make_mesh_cached_train_step

    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs in a "
                           f"process group of {n_devices} ranks")
    mesh = make_mesh(f"data:{n_devices}")
    dev = mesh.device
    batch, seq_s = 2 * n_devices, 4
    rows = mesh.rows(batch)
    rng0 = np.random.RandomState(1)
    recipe = dict(do_train=True, lr_init=1e-4, l2_wd=5e-4, max_grad_norm=5.0,
                  num_epochs=10)
    gen = lambda seed: torch.Generator().manual_seed(seed)

    # (1) flagship: detection, combined graph, laplacian supports; one row
    # of padding
    cfg = ExperimentConfig(graph_type="combined", num_rnn_layers=2,
                           **recipe).finalize()
    _, (x, lengths, supports) = _flagship(batch, seq_s, dev)
    y = torch.from_numpy(rng0.randint(0, 2, size=(batch,)).astype(
        np.float32)).to(dev)
    full = {"x": x, "y": y, "seq_lengths": lengths, "supports": supports,
            "valid": batch - 1}
    local = {"x": x[rows], "y": y[rows], "seq_lengths": lengths[rows],
             "supports": supports[:, rows], "valid": batch - 1}
    meshed = TrainStep(cfg, build_model(cfg, gen(0)), 10, mesh=mesh)
    single = TrainStep(cfg, build_model(cfg, gen(0)), 10, device=dev)
    loss_mesh = _finite(meshed(local), "data-parallel detection")
    loss_one = float(single(full))
    if not abs(loss_mesh - loss_one) <= 1e-4 * abs(loss_one):
        raise RuntimeError(f"dryrun (1): mesh loss {loss_mesh} against one "
                           f"rank's {loss_one}")
    one = single.model.state_dict()
    for k, v in meshed.model.state_dict().items():
        if not torch.allclose(v, one[k], rtol=5e-4, atol=1e-5):
            raise RuntimeError(f"dryrun (1): mesh parameter {k} diverged "
                               "from one rank's")

    # (2) correlation graph with dual random-walk supports, built on the
    # device from raw clips
    cfg2 = ExperimentConfig(graph_type="individual", num_rnn_layers=1,
                            max_seq_len=seq_s, use_fft=True,
                            **recipe).finalize()
    pipeline = make_device_pipeline(
        graph_type="individual", filter_type="dual_random_walk", top_k=3,
        use_fft=True, time_step_size=1, scaler=None, augment=False,
        num_nodes=N_NODES, device=dev)
    raw = rng0.randn(batch, N_NODES, seq_s * 200).astype(np.float32)
    step2 = TrainStep(cfg2, build_model(cfg2, gen(2)), 10, mesh=mesh,
                      input_pipeline=pipeline)
    _finite(step2({"raw": raw[rows], "y": y[rows],
                   "seq_lengths": lengths[rows]}), "raw-clip detection")

    # (3) the SSL encoder-decoder step (the curriculum's counter threaded)
    cfg3 = ExperimentConfig(task="SS pre-training", graph_type="combined",
                            num_rnn_layers=2, max_seq_len=seq_s,
                            output_seq_len=2, use_curriculum_learning=True,
                            **recipe).finalize()
    x3 = rng0.randn(batch, seq_s, N_NODES, D_IN).astype(np.float32)
    y3 = rng0.randn(batch, 2, N_NODES, D_IN).astype(np.float32)
    step3 = TrainStep(cfg3, build_model(cfg3, gen(3)), 10, mesh=mesh,
                      mean=0.0, std=1.0)
    _finite(step3({"x": x3[rows], "y": y3[rows],
                   "supports": supports[:, rows]}, batches_seen=0), "SSL")

    # (3b) the row-sharded device cache: each rank gathers its rows from
    # its own block; the plan's masks count real rows only
    n_clips = 3 * n_devices + 1  # ragged over the blocks
    feats = rng0.randn(n_clips, seq_s, N_NODES, D_IN).astype(np.float32)
    labels = (rng0.rand(n_clips) > 0.5).astype(np.float32)
    cache = DeviceDatasetCache(feats, labels, seq_s, mesh=mesh)
    idx_mat, mask_mat = cache.mesh_epoch_plan(batch, n_devices, True,
                                              np.random.RandomState(0))
    pipe_c = make_device_pipeline(
        graph_type="individual", filter_type="laplacian", top_k=3,
        use_fft=True, time_step_size=1, scaler=None, augment=False,
        num_nodes=N_NODES, device=dev)
    step_c = TrainStep(cfg, build_model(cfg, gen(0)), 10, mesh=mesh,
                       input_pipeline=pipe_c)
    losses = torch.zeros(len(idx_mat), device=dev)
    make_mesh_cached_train_step(step_c, seq_s, batch)(
        cache.x, cache.y,
        distributed.global_put(idx_mat.astype(np.int64), mesh, axis=1),
        distributed.global_put(mask_mat, mesh, axis=1), mask_mat.sum(1), 0,
        0, losses)
    _finite(losses[0], "mesh-cached")

    # (4) the ring SpMM inside a train step over a graph axis: the
    # block-diagonal batched clip graph over n ranks
    gmesh = make_mesh(f"graph:{n_devices}")
    model4 = DCRNNClassifier(DCRNNConfig(
        input_dim=12, rnn_units=16, num_rnn_layers=1, max_diffusion_step=1,
        num_nodes=N_NODES, num_supports=1), gen(4))
    adj4 = torch.from_numpy(np.abs(rng0.rand(n_devices, N_NODES, N_NODES))
                            .astype(np.float32))
    sgraph = partition_by_dest(from_dense_batch(
        compute_supports_torch(adj4, "laplacian")[0]), n_devices)
    x4 = rng0.randn(4, n_devices, N_NODES, 12).astype(np.float32)
    y4 = (rng0.rand(n_devices) > 0.5).astype(np.float32)
    step4 = make_sparse_train_step(
        model4, make_optimizer(model4.parameters(), 1e-3, 0.0, 5.0, 10, 10),
        gmesh)
    _finite(step4(sgraph, x4, y4), "sparse-distributed")


def _rank_main(rank: int, ranks: int, port: str, device) -> None:
    from eeg_gnn_tpu_torch.parallel import distributed

    distributed.initialize(f"tcp://127.0.0.1:{port}", ranks, rank,
                           local_world_size=ranks, device=device)
    try:
        dryrun_multichip(ranks)
    finally:
        distributed.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.ranks, args.port, args.device)
        return
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry forward: {tuple(out.shape)} {float(out.sum())}",
          flush=True)
    port = str(_free_port())
    extra = [] if args.device is None else ["--device", args.device]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "eeg_gnn_tpu_torch.entry", "--rank", str(r),
         "--ranks", str(args.ranks), "--port", port] + extra,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"dryrun_multichip({args.ranks}): rank exit codes "
                         f"{codes}")
    print(f"dryrun_multichip({args.ranks}): OK", flush=True)


if __name__ == "__main__":
    main()
