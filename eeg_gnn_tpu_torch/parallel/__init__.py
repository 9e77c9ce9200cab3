"""Scale-out over ``torch.distributed`` ranks (``eeg_gnn_tpu/parallel/``):
the mesh is the process group, one rank a card (NCCL), or ranks on the
CPU or sharing a card (gloo). Its ``data`` axis splits batch rows; its
``graph`` axis splits a block-diagonal clip graph's nodes and edges for
the ring SpMM (``edge_partition``, ``sparse_model``)."""

from eeg_gnn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    global_draws,
    make_mesh,
    parse_mesh_shape,
    rank_grid,
)
