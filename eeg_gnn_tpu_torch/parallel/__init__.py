"""Data-parallel scale-out over ``torch.distributed`` ranks
(``eeg_gnn_tpu/parallel/``): the mesh is the process group, one rank a
card (NCCL), or ranks on the CPU or sharing a card (gloo)."""

from eeg_gnn_tpu_torch.parallel.mesh import (  # noqa: F401
    GRAPH_AXIS,
    Mesh,
    global_draws,
    make_mesh,
    parse_mesh_shape,
)
