"""Multi-process runtime and per-rank data sharding
(``eeg_gnn_tpu/parallel/distributed.py``) on ``torch.distributed``.

Every rank calls :func:`initialize` before it touches a device. It reads
torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (or takes them as arguments) and forms
the process group:

- a rank's device is ``cuda:LOCAL_RANK``, or the CPU when the caller asks
  for it; where a host has fewer cards than local ranks, the ranks share
  them (``cuda:LOCAL_RANK % cards``);
- the backend follows the device: NCCL when each rank has a card of its
  own, gloo on the CPU, and gloo also when ranks share a card, because
  NCCL refuses two ranks on one device. gloo reads host memory, so a
  collective on a card's tensor goes through the host. One log line
  names the backend.

There is no fallback: a group that fails to form raises, and no
collective is retried on another backend.

Each rank's loaders materialize only its :func:`process_batch_slice` of
every global batch (the seeded shuffles are the same on every rank, so
slicing one index order is a partition), and :func:`form_global_array`
keeps this rank's rows on this rank's device: the rows of a global batch
never meet on one device.

The step's collectives carry counters, as the kernel wrappers count
their launches: :func:`all_reduce_grads` (the gradients' one all-reduce a
step, the loss riding in it; the sparse step's over the graph ring),
:func:`all_reduce_sum` (differentiable: the SSL loss's global numerator
and denominator, BatchNorm's global moments), :func:`all_gather_rows`
(the evaluation's and the Predictor's outputs; the graph axis's node
blocks), :func:`broadcast_` (the starting parameters) and
:func:`ring_shift` (the graph axis's point-to-point step of the ring
SpMM). Each has ``.calls`` (collectives launched) and ``.bytes`` (bytes
each rank sends into them); :func:`counts` reads them all,
:func:`reset_counts` sets them to 0. The data axis's collectives run over
the mesh's data group (``Mesh.group``), the graph axis's over its ring
(``Mesh.graph_group``).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from eeg_gnn_tpu_torch.parallel.mesh import Mesh

_STATE = {"device": None}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each local rank has a card of its own; gloo on the CPU
    and when ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    if local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               device=None) -> bool:
    """Form the process group (no-op for one process).

    Arguments left None come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; the address from
    ``MASTER_ADDR`` / ``MASTER_PORT``). With no ``init_method`` and a
    world of one there is nothing to form: returns False. Otherwise forms
    the group (``init_method`` defaults to
    ``tcp://MASTER_ADDR:MASTER_PORT``) and returns True; True also when
    the group exists already.

    ``device``: None means this rank's card (see the module docstring);
    ``"cpu"`` the CPU; an explicit ``"cuda:K"`` is used as given. The
    backend follows it (:func:`choose_backend`).
    """
    import torch.distributed as dist

    if world_size is None:
        world_size = _env_int("WORLD_SIZE") or 1
    if rank is None:
        rank = _env_int("RANK") or 0
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or world_size
    if dist.is_initialized():  # formed by the caller already
        return True
    if init_method is None and world_size == 1:
        return False
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        init_method = f"tcp://{addr}:{os.environ['MASTER_PORT']}"
    device = rank_device_for(device, local_rank, local_world_size)
    backend = choose_backend(device, local_world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _STATE["device"] = device
    print(f"distributed: rank {rank} of {world_size} on {device}, backend "
          f"{backend}" + (" (ranks share a card: NCCL takes one rank a "
                          "device)" if backend == "gloo"
                          and device.type == "cuda" else ""),
          file=sys.stderr, flush=True)
    return True


def rank_device_for(device, local_rank: int,
                    local_world_size: int) -> torch.device:
    """The device of local rank ``local_rank``: the caller's ``device``
    when it names one, else ``cuda:local_rank`` (round robin when the
    host has fewer cards than local ranks). Raises without a card."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device is available; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def rank_device() -> torch.device:
    """This rank's device, as :func:`initialize` chose it."""
    if _STATE["device"] is None:
        raise RuntimeError("no process group: call initialize() first")
    return _STATE["device"]


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_batch_slice(global_batch_size: int):
    """(start, size) of this rank's slice of a global batch: rank r owns
    rows [r*size, (r+1)*size)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, global_batch_size
    per = global_batch_size // dist.get_world_size()
    return dist.get_rank() * per, per


def process_shard() -> Optional[tuple]:
    """(rank, count) for the data loaders, or None for one process."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.get_rank(), dist.get_world_size()


def form_global_array(local, mesh: Mesh) -> torch.Tensor:
    """This rank's host rows of a global batch, on this rank's device (the
    global array is the ranks' rows together; no rank holds it all)."""
    t = local if isinstance(local, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(local))
    return t.to(mesh.device)


def global_put(full, mesh: Mesh, axis: int) -> torch.Tensor:
    """A host array that is the SAME on every rank (an epoch plan from one
    seeded rng), of which this rank keeps its block along ``axis``, on its
    device."""
    full = np.asarray(full)
    per = full.shape[axis] // mesh.world
    idx = [slice(None)] * full.ndim
    idx[axis] = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return form_global_array(np.ascontiguousarray(full[tuple(idx)]), mesh)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _count(fn, t: torch.Tensor):
    fn.calls += 1
    fn.bytes += t.numel() * t.element_size()


def _group(mesh: Mesh, axis: str):
    if axis not in ("data", "graph"):
        raise ValueError(f"unknown mesh axis {axis!r}")
    return mesh.group if axis == "data" else mesh.graph_group


def _reduce_(t: torch.Tensor, mesh: Mesh, axis: str = "data"
             ) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axis`` in place; gloo goes through
    the host."""
    import torch.distributed as dist

    group = _group(mesh, axis)
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh,
                     extra: Optional[torch.Tensor] = None,
                     axis: str = "data") -> Optional[torch.Tensor]:
    """Sum ``grads`` over the ranks of ``axis`` in place, in ONE
    all-reduce of a flat buffer (one a dtype when they differ); ``extra``
    (the loss's share, a 0-d tensor) rides at the end of the first buffer
    and comes back summed."""
    groups = {}
    for g in grads:
        groups.setdefault(g.dtype, []).append(g)
    out = None
    for i, (dtype, gs) in enumerate(groups.items()):
        parts = [g.reshape(-1) for g in gs]
        if i == 0 and extra is not None:
            parts.append(extra.detach().reshape(1).to(dtype))
        flat = torch.cat(parts)
        _count(all_reduce_grads, flat)
        _reduce_(flat, mesh, axis)
        lo = 0
        for g in gs:
            g.copy_(flat[lo:lo + g.numel()].view_as(g))
            lo += g.numel()
        if i == 0 and extra is not None:
            out = flat[lo].to(extra.dtype)
    if out is None and extra is not None:  # no gradient at all
        flat = extra.detach().reshape(1).clone()
        _count(all_reduce_grads, flat)
        out = _reduce_(flat, mesh, axis)[0]
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its cotangent is summed over the ranks too, the
    adjoint of a sum whose result every rank uses in its own share of the
    loss."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.detach().clone()
        _count(all_reduce_sum, out)
        return _reduce_(out, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        _count(all_reduce_sum, g)
        return _reduce_(g, ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (the backward sums the
    cotangents over the ranks)."""
    return _AllReduceSum.apply(x, mesh)


def all_gather_rows(t: torch.Tensor, mesh: Mesh,
                    axis: str = "data") -> torch.Tensor:
    """The ``t`` (equal shapes) of the ranks of ``axis`` concatenated along
    dimension 0 in axis order, on ``t``'s device: every rank gets the
    whole."""
    import torch.distributed as dist

    t = t.detach().contiguous()
    _count(all_gather_rows, t)
    src = t.cpu() if mesh.backend == "gloo" else t
    group = _group(mesh, axis)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_gather_host(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """A per-rank host array's rows gathered over the ranks, as numpy
    (the same on every rank); ``x`` itself without a mesh."""
    x = np.asarray(x)
    if mesh is None or mesh.world == 1:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    return all_gather_rows(t, mesh).cpu().numpy()


def broadcast_(tensors: List[torch.Tensor], mesh: Mesh, src: int = 0):
    """Overwrite ``tensors`` on every rank of the data axis with those of
    its data index ``src``, one broadcast a dtype."""
    import torch.distributed as dist

    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _count(broadcast_, flat)
        buf = flat.cpu() if mesh.backend == "gloo" else flat
        dist.broadcast(buf, mesh.data_ranks[src], group=mesh.group)
        lo = 0
        for t in ts:
            with torch.no_grad():
                t.copy_(buf[lo:lo + t.numel()].view_as(t))
            lo += t.numel()


class RingShift:
    """A :func:`ring_shift` in flight: :meth:`wait` returns the block
    received from graph index g-1."""

    def __init__(self, works, recv: torch.Tensor, device: torch.device):
        self.works, self.recv, self.device = works, recv, device

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.recv.to(self.device)


def ring_shift(t: torch.Tensor, mesh: Mesh) -> RingShift:
    """Send ``t`` to graph index g+1 and receive the block of g-1, around
    this rank's graph ring (JAX ``ppermute`` with the pairs ``(i, (i + 1)
    % p)``, ``edge_partition.py:121-122``). Both point-to-point ops go in
    one ``dist.batch_isend_irecv``: on NCCL between the cards, under gloo
    through the host. Returns at once; the result's ``wait()`` gives the
    received block (of ``t``'s shape, on ``t``'s device). On a ring of
    one it is ``t`` itself, and nothing is sent or counted. ``t`` must not
    change until then."""
    import torch.distributed as dist

    p, g = mesh.graph_world, mesh.graph_rank
    if p == 1:
        return RingShift((), t, t.device)
    t = t.contiguous()
    _count(ring_shift, t)
    src = t.cpu() if mesh.backend == "gloo" else t
    recv = torch.empty_like(src)
    ring = mesh.graph_ranks
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, ring[(g + 1) % p], mesh.graph_group),
        dist.P2POp(dist.irecv, recv, ring[(g - 1) % p], mesh.graph_group)])
    return RingShift(works, recv, t.device)


COLLECTIVES = (all_reduce_grads, all_reduce_sum, all_gather_rows,
               broadcast_, ring_shift)


def counts() -> dict:
    """{name: (calls, bytes)} of every counted collective."""
    return {f.__name__: (f.calls, f.bytes) for f in COLLECTIVES}


def reset_counts():
    for f in COLLECTIVES:
        f.calls = 0
        f.bytes = 0


reset_counts()


def shutdown():
    """Destroy the process group (when there is one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None
