"""Meshes over ``torch.distributed`` ranks (``eeg_gnn_tpu/parallel/mesh.py``).

The JAX package runs a mesh inside one program, one process per host, its
devices the mesh. The port follows PyTorch's idiom of one process per
card: the mesh IS the process group, its ranks laid out in a grid as JAX
lays out devices (``devices.reshape(sizes)`` in the spec's axis order).
Under ``data:N,graph:M`` rank r sits at data index ``r // M`` and graph
index ``r % M``.

- ``data`` axis: rank r of a ``data:N`` mesh holds the contiguous rows
  ``[r*B/N, (r+1)*B/N)`` of every global batch of B rows, the layout of
  the JAX package's ``process_batch_slice``. Parameters are replicated
  (each rank holds them all and updates them identically); batch rows
  are the only thing split. Random draws of a step (augmentation, head
  dropout) are made for the GLOBAL batch on every rank and each rank
  keeps its rows (:func:`global_draws`, :func:`rand`), so N ranks draw
  what one rank draws for the same batch and their generators stay in
  step.
- ``graph`` axis: the nodes of a block-diagonal batched clip graph and
  its edges, split by destination block over the ranks of one data row
  (``parallel/edge_partition.py``, ``parallel/sparse_model.py``). The
  data paths treat it as a replica axis, as ``shard_map`` does an axis
  its specs do not name.

The mesh holds one ``torch.distributed`` group per data row (the graph
ring) and one per graph column (the data axis's collectives). Every rank
creates every group, in the same order; an axis that spans every rank
uses the default group, so a ``data:N`` mesh's collectives are those of
the whole process group.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

AXES = ("data", "graph")


def parse_mesh_shape(spec: str, num_devices: Optional[int] = None):
    """Parse "data:-1" / "data:4,graph:2" into (names, sizes); -1 infers
    the size from ``num_devices`` (default: the process group's world
    size, 1 without a group)."""
    names, sizes = [], []
    for part in spec.split(","):
        name, size = part.split(":")
        names.append(name.strip())
        sizes.append(int(size))
    n = num_devices if num_devices is not None else _world_size()
    if any(s == -1 for s in sizes):
        known = int(np.prod([s for s in sizes if s != -1]))
        missing = n // known
        sizes = [missing if s == -1 else s for s in sizes]
    return tuple(names), tuple(sizes)


def check_axes(names) -> None:
    """Raise for an axis other than ``data`` and ``graph``, or one named
    twice."""
    for name in names:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"mesh axes named twice: {tuple(names)}")


def rank_grid(names, sizes) -> np.ndarray:
    """The global ranks as a (data, graph) grid: ``arange(world)``
    reshaped to ``sizes`` in the spec's axis order (JAX's device layout),
    an absent axis of size 1."""
    check_axes(names)
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    grid = grid.transpose([list(names).index(a) for a in AXES
                           if a in names])
    shape = dict(zip(names, sizes))
    return grid.reshape(shape.get("data", 1), shape.get("graph", 1))


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of the ranks of a process group.

    Attributes:
        axis_names / axis_sizes: e.g. ``("data",)`` and ``(world,)``.
        rank, world: this rank's index on the ``data`` axis and the axis's
            size (1 without one); for a ``data:N`` mesh, the process rank
            and the world size.
        device: this rank's device (``cuda:LOCAL_RANK``, a shared card, or
            the CPU).
        backend: ``"nccl"`` or ``"gloo"``.
        group: the data axis's group of this rank (None: the default
            group).
        graph_rank, graph_world: this rank's index on the ``graph`` axis
            and its size (1 without one).
        graph_group: the graph ring's group of this rank (None: the
            default group).
        grid: the (data, graph) grid of global ranks (:func:`rank_grid`);
            None for a data mesh over the whole group.
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None
    graph_rank: int = 0
    graph_world: int = 1
    graph_group: Any = None
    grid: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def data_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's data column, in data order."""
        if self.grid is None:
            return tuple(range(self.world))
        return tuple(row[self.graph_rank] for row in self.grid)

    @property
    def graph_ranks(self) -> Tuple[int, ...]:
        """The global ranks of this rank's graph ring, in graph order."""
        if self.grid is None:
            return (self.rank,)
        return self.grid[self.rank]

    def per_rank(self, global_batch: int) -> int:
        """Rows of a global batch each rank holds; the batch must split
        evenly."""
        if global_batch % self.world:
            raise ValueError(f"batch size {global_batch} must divide over "
                             f"{self.world} ranks")
        return global_batch // self.world

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (``batch_sharding``'s split:
        contiguous blocks in data order)."""
        per = self.per_rank(global_batch)
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(spec: str = "data:-1") -> Mesh:
    """The mesh of the process group that ``parallel.distributed.
    initialize`` formed: ``data:-1`` spans every rank on the data axis,
    ``graph:P`` every rank on the graph axis, ``data:N,graph:M`` N rows
    of M. The sizes must multiply to the world size. Every rank calls it
    (it creates the axes' groups). Raises without a process group: a
    mesh never falls back to one rank on its own."""
    import torch.distributed as dist

    from eeg_gnn_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "eeg_gnn_tpu_torch.parallel.distributed."
                           "initialize() first")
    world = dist.get_world_size()
    names, sizes = parse_mesh_shape(spec, world)
    grid = rank_grid(names, sizes)
    if grid.size != world:
        raise ValueError(f"mesh {spec!r} asks for {sizes} ranks; the "
                         f"process group has {world}")
    n_data, n_graph = grid.shape
    # torch.distributed's rule: every rank creates every group, in order
    data_groups = [None] * n_graph if n_data == world else [
        dist.new_group(grid[:, g].tolist()) for g in range(n_graph)]
    graph_groups = [None] * n_data if n_graph == world else [
        dist.new_group(grid[d].tolist()) for d in range(n_data)]
    d, g = (int(i) for i in np.argwhere(grid == dist.get_rank())[0])
    return Mesh(names, sizes, d, n_data, distributed.rank_device(),
                dist.get_backend(), data_groups[g], g, n_graph,
                graph_groups[d], tuple(map(tuple, grid.tolist())))


# ---------------------------------------------------------------------------
# draws for the global batch
# ---------------------------------------------------------------------------

_DRAW_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "eeg_gnn_tpu_torch_draw_rows", default=None)


@contextlib.contextmanager
def global_draws(lo: int, total: int):
    """Inside, :func:`rand` draws for a global batch of ``total`` rows and
    returns rows ``[lo, lo + local)``: the train step of rank r runs its
    loss under ``global_draws(r * local, world * local)``."""
    token = _DRAW_ROWS.set((lo, total))
    try:
        yield
    finally:
        _DRAW_ROWS.reset(token)


def rand(shape, generator: Optional[torch.Generator], device,
         batch_axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` whose axis ``batch_axis`` is the batch: under
    :func:`global_draws`, the global batch's draws, of which this rank's
    rows come back; otherwise a plain draw."""
    rows = _DRAW_ROWS.get()
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    lo, total = rows
    full = list(shape)
    n = full[batch_axis]
    full[batch_axis] = total
    u = torch.rand(full, generator=generator, device=device)
    return u.narrow(batch_axis, lo, n)
