"""The graph-axis cases of ``tests/test_torch_graph_axis.py``: the seeded
inputs that the port's ranks and the JAX ``graph:4`` mesh share, and the
port's rank worker, which imports no JAX:

    python tests/torch_graph_cases.py RANK WORLD PORT OUT_DIR

forms a gloo group of WORLD ranks on the CPU (``tcp://127.0.0.1:PORT``)
and runs every case: the ring SpMM at the JAX test's four shapes with its
dx and dvalues, the sparse encoder, 3 sparse train steps (and the first
step's gradients), a ``data:2,graph:2`` mesh's coordinates and groups with
the data-parallel detection step through it and through a plain
``data:2`` mesh, and ``dryrun_multichip(WORLD)``. It writes
``OUT_DIR/rank{RANK}.npz``.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# tests/test_sparse_distributed.py's shapes (n_nodes, feat, edges): 250
# nodes and 777 edges keep both padding paths at p=4
RING_SHAPES = ((8 * 19 * 2, 16, 8 * 64), (64, 128, 8 * 64),
               (256, 32, 1000), (250, 16, 777))
# the encoder and the step: T, B, N, input_dim, units, K, layers
T, B, N, DIN, H, K = 3, 4, 19, 8, 8, 2
ENC_LAYERS, STEP_LAYERS, STEPS = 2, 1, 3
OPT = (1e-3, 0.0, 5.0, 10, 10)  # lr, L2, clip, epochs, steps an epoch


def ring_inputs(i):
    """(rows, cols, values, x, cotangent) of ring shape ``i``."""
    n, feat, e = RING_SHAPES[i]
    rng = np.random.RandomState(100 + i)
    return (rng.randint(0, n, e).astype(np.int32),
            rng.randint(0, n, e).astype(np.int32),
            rng.randn(e).astype(np.float32),
            rng.randn(n, feat).astype(np.float32),
            rng.randn(n, feat).astype(np.float32))


def clip_inputs(seed):
    """(x_seq (T, B, N, DIN), y (B,), laplacian supports (B, N, N)): the
    supports from the port's host numpy ``compute_supports``, shared by
    both packages."""
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports

    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, N, DIN).astype(np.float32)
    y = (rng.rand(B) > 0.5).astype(np.float32)
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    sup = np.stack([compute_supports(a, "laplacian")[0] for a in adj])
    return x, y, sup.astype(np.float32)


def model_cfg(layers):
    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNConfig

    return DCRNNConfig(input_dim=DIN, rnn_units=H, num_rnn_layers=layers,
                       max_diffusion_step=K, num_nodes=N, num_supports=1,
                       num_classes=1, recurrence="stacked")


def init_model(layers, seed):
    """A seeded ``DCRNNClassifier`` (the JAX side through
    ``io.params_to_jax``)."""
    import torch

    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier

    return DCRNNClassifier(model_cfg(layers),
                           torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# the port's rank worker
# ---------------------------------------------------------------------------


def _numpy(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def ring_case(mesh, out):
    import dataclasses

    import torch

    from eeg_gnn_tpu_torch.graphs.sparse import SparseGraph
    from eeg_gnn_tpu_torch.parallel import distributed
    from eeg_gnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_spmm,
        gather_blocks,
        place_edge_partitioned,
    )

    for i, (n, _, _) in enumerate(RING_SHAPES):
        rows, cols, vals, x, w = ring_inputs(i)
        g = SparseGraph(torch.from_numpy(rows), torch.from_numpy(cols),
                        torch.from_numpy(vals), n)
        shard, x_block = place_edge_partitioned(mesh, g, torch.from_numpy(x))
        values = shard.values.clone().requires_grad_()
        x_block.requires_grad_()
        block = edge_partitioned_spmm(
            mesh, dataclasses.replace(shard, values=values), x_block)
        full = gather_blocks(mesh, block, n)
        (full * torch.from_numpy(w)).sum().backward()
        out[f"ring/{i}/out"] = full.detach().numpy()
        out[f"ring/{i}/dx"] = gather_blocks(mesh, x_block.grad, n).numpy()
        out[f"ring/{i}/dvalues"] = distributed.all_gather_rows(
            values.grad, mesh, axis="graph").numpy()


def encoder_case(mesh, out):
    import torch

    from eeg_gnn_tpu_torch.graphs.sparse import from_dense_batch
    from eeg_gnn_tpu_torch.parallel.edge_partition import partition_by_dest
    from eeg_gnn_tpu_torch.parallel.sparse_model import sparse_encoder_apply

    model = init_model(ENC_LAYERS, 1)
    x, _, sup = clip_inputs(1)
    sgraph = partition_by_dest(from_dense_batch(torch.from_numpy(sup)),
                               mesh.graph_world)
    with torch.no_grad():
        stack, seq = sparse_encoder_apply(
            model.cell_cfgs, [c.params() for c in model.encoder], mesh,
            sgraph, torch.from_numpy(x))
    out["encoder/stack"], out["encoder/seq"] = stack.numpy(), seq.numpy()


def step_case(mesh, out):
    import torch

    from eeg_gnn_tpu_torch.graphs.sparse import from_dense_batch
    from eeg_gnn_tpu_torch.parallel import distributed
    from eeg_gnn_tpu_torch.parallel.edge_partition import partition_by_dest
    from eeg_gnn_tpu_torch.parallel.sparse_model import make_sparse_train_step
    from eeg_gnn_tpu_torch.train.optim import make_optimizer

    model = init_model(STEP_LAYERS, 2)
    x, y, sup = clip_inputs(2)
    sgraph = partition_by_dest(from_dense_batch(torch.from_numpy(sup)),
                               mesh.graph_world)
    step = make_sparse_train_step(
        model, make_optimizer(model.parameters(), *OPT), mesh)
    distributed.reset_counts()
    for i in range(STEPS):
        loss = step.loss_and_grads(sgraph, x, y)
        if i == 0:
            out.update({f"step/grad/{k}": p.grad.numpy().copy()
                        for k, p in model.named_parameters()})
        step.optimizer.step()
        out[f"step/{i}/loss"] = np.float64(loss)
        out.update({f"step/{i}/{k}": v
                    for k, v in _numpy(model.state_dict()).items()})
    out["step/counts"] = np.asarray(
        [v for pair in distributed.counts().values() for v in pair])


def mesh_case(out, world):
    """A data:2,graph:2 mesh: its coordinates and groups, and the
    data-parallel detection step through it (a replica on each graph
    index) and through a plain data:2 mesh of ranks 0 and 1."""
    import torch
    import torch.distributed as dist

    import torch_dp_cases as dp
    from eeg_gnn_tpu_torch.parallel import make_mesh
    from eeg_gnn_tpu_torch.parallel.mesh import Mesh

    mesh = make_mesh("data:2,graph:2")
    me = dist.get_rank()
    onehot = torch.zeros(world)
    onehot[me] = 1.0
    members = {}
    for axis, group in (("data", mesh.group), ("graph", mesh.graph_group)):
        t = onehot.clone()
        dist.all_reduce(t, group=group)
        members[axis] = t.numpy()
    out["mesh/coords"] = np.asarray([mesh.rank, mesh.world, mesh.graph_rank,
                                     mesh.graph_world])
    out["mesh/data_ranks"] = np.asarray(mesh.data_ranks)
    out["mesh/graph_ranks"] = np.asarray(mesh.graph_ranks)
    out["mesh/data_members"] = members["data"]
    out["mesh/graph_members"] = members["graph"]
    for i, (_, state) in enumerate(dp.run_case("detection", mesh, None)):
        out.update({f"dg/{i}/{k}": v for k, v in state.items()})
    pair = dist.new_group([0, 1])
    if me < 2:
        plain = Mesh(("data",), (2,), me, 2, torch.device("cpu"), "gloo",
                     pair)
        for i, (_, state) in enumerate(dp.run_case("detection", plain,
                                                   None)):
            out.update({f"d2/{i}/{k}": v for k, v in state.items()})


def main(rank, world, port, out_dir):
    import torch

    from eeg_gnn_tpu_torch.entry import dryrun_multichip
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh

    torch.set_num_threads(1)
    distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                           device="cpu")
    out = {}
    mesh = make_mesh(f"graph:{world}")
    ring_case(mesh, out)
    encoder_case(mesh, out)
    step_case(mesh, out)
    mesh_case(out, world)
    dryrun_multichip(world)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
