"""Data-parallel meshes over ``torch.distributed`` ranks
(``eeg_gnn_tpu/parallel/mesh.py``).

The JAX package runs a mesh's ``data`` axis inside one program, one
process per host, its devices the axis. The port follows PyTorch's idiom
of one process per card: the mesh IS the process group. A ``data:N``
mesh is N ranks, and rank r holds the contiguous rows ``[r*B/N,
(r+1)*B/N)`` of every global batch of B rows, the layout of the JAX
package's ``process_batch_slice``. Parameters are replicated (each rank
holds them all and updates them identically); batch rows are the only
thing split.

Random draws of a step (augmentation, head dropout) are made for the
GLOBAL batch on every rank and each rank keeps its rows
(:func:`global_draws`, :func:`rand`), so N ranks draw what one rank
draws for the same batch and their generators stay in step.

Only the ``data`` axis is ported. The JAX package's ``graph`` axis (the
edge-partitioned ring SpMM) raises ``NotImplementedError``
(:data:`GRAPH_AXIS`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

GRAPH_AXIS = ("the mesh's graph axis is not ported yet (ROADMAP.md, Queue "
              "1, item 12: the graph axis)")


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
    """Raise for any axis but ``data``: the graph axis is still to port."""
    for name in names:
        if name == "graph":
            raise NotImplementedError(GRAPH_AXIS)
        if name != "data":
            raise ValueError(f"unknown mesh axis {name!r}")


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` mesh: the ranks of a process group.

    Attributes:
        axis_names / axis_sizes: ``("data",)`` and ``(world,)``.
        rank, world: this process's rank and the group's size.
        device: this rank's device (``cuda:LOCAL_RANK``, a shared card, or
            the CPU).
        backend: ``"nccl"`` or ``"gloo"``.
        group: the process group (None: the default group).
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def per_rank(self, global_batch: int) -> int:
        """Rows of a global batch each rank holds; the batch must split
        evenly."""
        if global_batch % self.world:
            raise ValueError(f"batch size {global_batch} must divide over "
                             f"{self.world} ranks")
        return global_batch // self.world

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (``batch_sharding``'s split:
        contiguous blocks in rank order)."""
        per = self.per_rank(global_batch)
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(spec: str = "data:-1") -> Mesh:
    """The mesh of the process group that ``parallel.distributed.
    initialize`` formed: ``data:-1`` (or ``data:<world>``) spans every
    rank. Raises without a process group: a mesh never falls back to one
    rank on its own."""
    import torch.distributed as dist

    from eeg_gnn_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "eeg_gnn_tpu_torch.parallel.distributed."
                           "initialize() first")
    names, sizes = parse_mesh_shape(spec, dist.get_world_size())
    check_axes(names)
    if sizes != (dist.get_world_size(),):
        raise ValueError(f"mesh {spec!r} asks for {sizes} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return Mesh(names, sizes, dist.get_rank(), dist.get_world_size(),
                distributed.rank_device(), dist.get_backend())


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
