"""DCGRU on edge-partitioned sparse supports: the distributed-SpMM model
path (``eeg_gnn_tpu/parallel/sparse_model.py``).

A batch's clip graphs form one block-diagonal ``SparseGraph`` over B*N
nodes (``graphs/sparse.py``); its edges are partitioned over the mesh's
``graph`` axis and the node features split in the same blocks, so every
diffusion step inside the DCGRU cell is a ring SpMM
(``parallel/edge_partition.py``). Everything else in the cell is a
per-node product on this rank's block. The path runs in float32 with a
single support, as the JAX package's: a config with more than one
support (``dual_random_walk``) is not reached.

The train step (:class:`SparseTrainStep`) runs on a
``models.dcrnn.DCRNNClassifier``'s encoder cells and ``fc`` (JAX's step
tree ``{encoder, fc_w, fc_b}`` is the classifier's, so
``io.params_from_jax`` carries JAX weights across unchanged). Node blocks
need not align with clips, so the head (ReLU, per-node FC, max over
nodes, BCE) runs on the gathered last states, the same on every rank;
the encoder's gradients are each rank's share of the node-sharded work
and are summed over the graph ring, the head's count once. A data axis
beside the graph axis replicates the step, as ``shard_map`` does an axis
its specs do not name.

Cell math: reference ``model/cell.py:182-210``.
"""

from __future__ import annotations

from typing import Union

import torch

from eeg_gnn_tpu_torch.ops.recurrent import _act_pair
from eeg_gnn_tpu_torch.parallel import distributed
from eeg_gnn_tpu_torch.parallel.edge_partition import (
    EdgeShard,
    PartitionedGraph,
    edge_partitioned_spmm,
    gather_blocks,
    local_shard,
    node_block,
)
from eeg_gnn_tpu_torch.parallel.mesh import Mesh
from eeg_gnn_tpu_torch.train.losses import bce_with_logits

Graph = Union[PartitionedGraph, EdgeShard]


def sparse_chebyshev_diffusion(mesh: Mesh, shard: EdgeShard,
                               x_block: torch.Tensor, k: int) -> torch.Tensor:
    """K-step Chebyshev diffusion where every S @ x is a ring SpMM.

    Args:
        x_block: (blk, D) this rank's node block of the features.

    Returns:
        (blk, D*M) features in the reference's d-major layout (m fastest),
        as ``ops/diffusion.chebyshev_diffusion`` and ``models.dcgru._flat``
        for a single support (A_0 = I).
    """
    feats = [x_block]
    x0 = x_block
    if k >= 1:
        x1 = edge_partitioned_spmm(mesh, shard, x0)
        feats.append(x1)
        for _ in range(2, k + 1):
            x2 = 2.0 * edge_partitioned_spmm(mesh, shard, x1) - x0
            feats.append(x2)
            x0, x1 = x1, x2
    return torch.stack(feats, dim=-1).reshape(x_block.shape[0], -1)


def sparse_cell_apply(cfg, params, mesh: Mesh, shard: EdgeShard,
                      x_block: torch.Tensor,
                      h_block: torch.Tensor) -> torch.Tensor:
    """One DCGRU step with ring-SpMM diffusion on this rank's node block:
    ``models.dcgru.dcgru_cell_apply`` with a single support; operands
    (blk, D) / (blk, H)."""
    act, _ = _act_pair(cfg.activation)
    h_units, k = cfg.num_units, cfg.max_diffusion_step
    xh = torch.cat([x_block, h_block], dim=-1)
    xh_feat = sparse_chebyshev_diffusion(mesh, shard, xh, k)
    ru = torch.sigmoid(xh_feat @ params["gate_w"] + params["gate_b"])
    r, u = ru[:, :h_units], ru[:, h_units:]
    xrh = torch.cat([x_block, r * h_block], dim=-1)
    xrh_feat = sparse_chebyshev_diffusion(mesh, shard, xrh, k)
    c = act(xrh_feat @ params["cand_w"] + params["cand_b"])
    return u * h_block + (1.0 - u) * c


def sparse_encoder_blocks(cfgs, params, mesh: Mesh, shard: EdgeShard,
                          x_blocks: torch.Tensor, h0_block=None):
    """The stacked encoder on this rank's node block: ``x_blocks`` (T,
    blk, input_dim) -> (last states (L, blk, H), top sequence (T, blk,
    H)). ``h0_block``: (blk, H), every layer's initial state (zeros by
    default)."""
    h_units = cfgs[0].num_units
    cur = x_blocks
    lasts = []
    for cfg, p in zip(cfgs, params):
        h = (x_blocks.new_zeros((x_blocks.shape[1], h_units))
             if h0_block is None else h0_block)
        seq = []
        for x_t in cur:
            h = sparse_cell_apply(cfg, p, mesh, shard, x_t, h)
            seq.append(h)
        cur = torch.stack(seq)
        lasts.append(h)
    return torch.stack(lasts), cur


def sparse_encoder_apply(cfgs, params, mesh: Mesh, sgraph: Graph,
                         x_seq: torch.Tensor, h0=None):
    """Stacked DCGRU encoder whose diffusion runs on the ring SpMM.

    Args:
        x_seq: (T, B, N, input_dim) time-major input, the same on every
            rank.
        sgraph: the block-diagonal graph over B*N nodes (single support),
            partitioned by ``partition_by_dest`` (or this rank's shard).
        h0: optional (B*N, H) initial state of every layer.

    Returns:
        (hidden_stack (L, B, N, H), top_seq (T, B, N, H)), gathered on
        every rank: ``models.dcgru.encoder_apply``'s contract.
    """
    shard = local_shard(mesh, sgraph)
    t, b, n, _ = x_seq.shape
    if shard.num_nodes != b * n:
        raise ValueError(f"graph over {shard.num_nodes} nodes; the batch "
                         f"has {b} x {n}")
    n_pad = shard.num_nodes_padded
    x_blocks = node_block(mesh, x_seq.reshape(t, b * n, -1), n_pad, dim=1)
    h0_block = None if h0 is None else node_block(mesh, h0, n_pad)
    lasts, top = sparse_encoder_blocks(cfgs, params, mesh, shard, x_blocks,
                                       h0_block)
    h = cfgs[0].num_units
    return (gather_blocks(mesh, lasts, b * n, dim=1).reshape(-1, b, n, h),
            gather_blocks(mesh, top, b * n, dim=1).reshape(t, b, n, h))


class SparseTrainStep:
    """The detection train step on the ring-SpMM encoder: forward, last
    state, ReLU, per-node FC, max over nodes, BCE, gradients, update
    (JAX ``make_sparse_train_step``, the dense step's structure).

    Args:
        model: a ``DCRNNClassifier`` (its encoder cells and ``fc``; its
            dropout and recurrence settings are not read), moved to the
            mesh's device. Every rank starts from the same weights.
        optimizer: a ``train.optim.Optimizer`` over ``model``'s
            parameters.
        mesh: a mesh with a graph axis (``make_mesh("graph:P")``).

    A call ``step(sgraph, x_seq, y)`` takes the partitioned block-diagonal
    graph (or this rank's shard), time-major (T, B, N, input_dim) clips
    and (B,) labels, the same on every rank, and returns the loss as a
    0-d device tensor.
    """

    def __init__(self, model, optimizer, mesh: Mesh):
        self.model = model.to(mesh.device)
        self.optimizer = optimizer
        self.mesh = mesh
        self.cfgs = model.cell_cfgs
        self.node_sharded = [p for cell in model.encoder
                             for p in cell.parameters()]

    def loss(self, sgraph: Graph, x_seq: torch.Tensor, y: torch.Tensor):
        """(loss, logits (B, C)), the same on every rank."""
        mesh, dev = self.mesh, self.mesh.device
        shard = local_shard(mesh, sgraph)
        x_seq = torch.as_tensor(x_seq, dtype=torch.float32).to(dev)
        t, b, n, _ = x_seq.shape
        x_blocks = node_block(mesh, x_seq.reshape(t, b * n, -1),
                              shard.num_nodes_padded, dim=1)
        _, top = sparse_encoder_blocks(
            self.cfgs, [c.params() for c in self.model.encoder], mesh,
            shard, x_blocks)
        last = gather_blocks(mesh, top[-1], b * n).reshape(b, n, -1)
        logits = self.model.fc(torch.relu(last)).amax(dim=1)
        y = torch.as_tensor(y, dtype=torch.float32).to(dev)
        return bce_with_logits(logits, y), logits

    def loss_and_grads(self, sgraph: Graph, x_seq, y) -> torch.Tensor:
        """Forward and backward: ``.grad`` holds the whole batch's
        gradients (the encoder's summed over the graph ring)."""
        self.optimizer.zero_grad()
        loss, _ = self.loss(sgraph, x_seq, y)
        loss.backward()
        for p in self.node_sharded:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh.graph_world > 1:
            distributed.all_reduce_grads([p.grad for p in self.node_sharded],
                                         self.mesh, axis="graph")
        return loss.detach()

    def __call__(self, sgraph: Graph, x_seq, y) -> torch.Tensor:
        loss = self.loss_and_grads(sgraph, x_seq, y)
        self.optimizer.step()
        return loss


def make_sparse_train_step(model, optimizer, mesh: Mesh) -> SparseTrainStep:
    """The train step over ``model`` (a ``DCRNNClassifier``) on the ring
    SpMM of ``mesh``'s graph axis (:class:`SparseTrainStep`)."""
    return SparseTrainStep(model, optimizer, mesh)
