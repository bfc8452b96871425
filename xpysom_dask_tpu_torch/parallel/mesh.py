"""Data-parallel process groups for the PyTorch port.

Counterpart of ``xpysom_dask_tpu/parallel/mesh.py``. JAX lays a 1-D
``'data'`` mesh over devices and ``psum``s each epoch's statistics inside
``shard_map``. The port runs one process per card instead, joined by
``torch.distributed``: a :class:`DataMesh` is a process group with this
process's rank, the world size and this process's device. Each rank holds
its own contiguous block of the ``(C, chunk, D)`` chunks (JAX's
``P('data')`` split of the leading axis), runs the single-device kernels
on it, and one ``all_reduce(SUM)`` of the epoch's running ``[S | cnt]``
takes the place of the ``psum``; every rank then applies the same
codebook update.

What the user's ``mesh=`` means (:func:`resolve_mesh`):

- ``None``/``False``: no mesh, the single-device path;
- ``True``/``'auto'``: the default process group (a world of 1 when none
  is initialized);
- an int ``k``: the default process group, which must have ``k`` ranks;
- a ``torch.distributed.ProcessGroup``: used as it is;
- a (data, model) grid: codebook sharding, not ported yet.

Gloo on CUDA tensors offers ``broadcast`` and ``all_reduce`` only, so
every collective here is an ``all_reduce``: a count is a MAX of one
element, and a gather (:func:`fetch_global`) an ``all_reduce`` of a
zero-filled ``(world, ...)`` buffer in which each rank writes its own row,
summed as integers so that every value arrives bit for bit. The same path
runs under NCCL, on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.hw import resolve_device

__all__ = [
    "DataMesh",
    "initialize_multihost",
    "make_data_mesh",
    "resolve_mesh",
    "is_grid_mesh",
    "mesh_spans_processes",
    "process_topology",
    "put_with_sharding",
    "fetch_global",
    "all_reduce_sum",
    "barrier",
]


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 "
        f"item {item})"
    )


@dataclass(frozen=True, eq=False)
class DataMesh:
    """A data-parallel process group as the port's mesh: ``group`` (None
    for the default group, or where ``torch.distributed`` is not
    initialized and the world is this process), this process's ``rank``,
    the ``world`` size and this process's ``device``."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device

    def __repr__(self):
        backend = dist.get_backend(self.group) if dist.is_initialized() else None
        return (
            f"DataMesh(rank={self.rank}, world={self.world}, "
            f"backend={backend!r}, device={str(self.device)!r})"
        )


def process_topology(mesh=None):
    """``(rank, world size)`` of ``mesh``; without one, of the default
    process group when ``torch.distributed`` is initialized, else
    ``(0, 1)``."""
    if mesh is not None:
        return mesh.rank, mesh.world
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rank_device(rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` when given, else the card
    ``cuda:{LOCAL_RANK}`` (the launcher's local rank), or ``cuda:{rank %
    cards}`` without one. Without a card that is an error, as
    ``device=None`` is everywhere in the port."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         backend=None, *, device=None):
    """Join a multi-process run: ``torch.distributed.init_process_group``
    for this process, one process per card. Call once per process before
    building a model with ``mesh='auto'``.

    ``coordinator_address`` is an init method (``'tcp://host:port'``,
    ``'file:///shared/path'``; a bare ``'host:port'`` means tcp); None
    reads the launcher's environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them).
    ``backend=None`` means NCCL when this process's device (``device=``,
    default the card) is a card and gloo on the CPU; an explicit
    ``backend`` is used as given: nothing swaps one for the other. NCCL
    refuses two ranks on one card ("Duplicate GPU detected"), so ranks
    that share a card need ``backend='gloo'``. On the card, the rank's
    device becomes the current one."""
    dev_type = resolve_device(device).type
    if backend is None:
        backend = "gloo" if dev_type == "cpu" else "nccl"
    init = coordinator_address or "env://"
    if "://" not in init:
        init = "tcp://" + init
    dist.init_process_group(
        backend,
        init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
    )
    if dev_type == "cuda":
        torch.cuda.set_device(_rank_device(dist.get_rank(), device))


def make_data_mesh(n_processes: Optional[int] = None, group=None, device=None) -> DataMesh:
    """The data mesh over ``group`` (default: the default process group;
    a world of 1 when ``torch.distributed`` is not initialized).
    ``n_processes``, when given, must be the group's world size: the port
    runs one process per card, so a mesh cannot span fewer or more
    processes than the group has."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        global_rank = dist.get_rank()
    elif group is not None:
        raise ValueError("a process group needs torch.distributed to be initialized")
    else:
        rank, world, global_rank = 0, 1, 0
    if n_processes is not None and int(n_processes) != world:
        raise ValueError(
            f"mesh={n_processes}: the port runs one process per card, so a data "
            f"mesh spans the {world} process(es) of its process group; start "
            f"{n_processes} processes (initialize_multihost, or torchrun "
            f"--nproc-per-node={n_processes}) and pass mesh='auto'"
        )
    return DataMesh(group, rank, world, _rank_device(global_rank, device))


def is_grid_mesh(mesh) -> bool:
    """True for a (data, model) grid: a pair of sizes, or a mesh object
    whose axis names hold ``'model'`` (a JAX ``Mesh``, a torch
    ``DeviceMesh``)."""
    if isinstance(mesh, (tuple, list)):
        return len(mesh) == 2
    names = getattr(mesh, "axis_names", None) or getattr(mesh, "mesh_dim_names", None) or ()
    return "model" in names


def resolve_mesh(mesh, device=None) -> Optional[DataMesh]:
    """Normalize the user-facing ``mesh`` argument (module docstring) to a
    :class:`DataMesh` or None. ``device`` is this process's device (default:
    its card, :func:`_rank_device`)."""
    if mesh is None or mesh is False:
        return None
    if isinstance(mesh, DataMesh):
        return mesh
    if mesh is True or (isinstance(mesh, str) and mesh == "auto"):
        return make_data_mesh(device=device)
    if is_grid_mesh(mesh):
        _not_ported("a (data, model) grid mesh (codebook sharding)", 11)
    if isinstance(mesh, (int, np.integer)):
        return make_data_mesh(int(mesh), device=device)
    if dist.is_available() and isinstance(mesh, dist.ProcessGroup):
        return make_data_mesh(group=mesh, device=device)
    raise TypeError(f"cannot interpret mesh argument {mesh!r}")


def mesh_spans_processes(mesh) -> bool:
    """True when ``mesh`` joins more than one process."""
    return mesh is not None and mesh.world > 1


def put_with_sharding(arr: np.ndarray, mesh, device=None) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``arr`` (which
    every rank holds in full: resident data, padded to a multiple of the
    world size by ``chunk_data(multiple_of=)``) on the rank's device; the
    whole array on ``device`` without a mesh."""
    if mesh is None:
        return torch.from_numpy(arr).to(device)
    if arr.shape[0] % mesh.world:
        raise ValueError(
            f"{arr.shape[0]} rows do not split evenly over {mesh.world} ranks"
        )
    per = arr.shape[0] // mesh.world
    block = np.ascontiguousarray(arr[mesh.rank * per : (mesh.rank + 1) * per])
    return torch.from_numpy(block).to(mesh.device)


# integer types of the same width, for gathers that must carry every bit
_BITS = {
    torch.float32: torch.int32,
    torch.float64: torch.int64,
    torch.int32: torch.int32,
    torch.int64: torch.int64,
}


def fetch_global(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``tensor`` (the same shape and dtype on every rank),
    concatenated along the leading axis in rank order, on every rank: the
    inverse of :func:`put_with_sharding`. An ``all_reduce`` of a zero-filled
    ``(world, ...)`` buffer in which each rank writes its own row, on the
    tensor's device, summed as integers of the same width so the values
    arrive bit for bit (``-0.0`` and NaN payloads included). ``tensor``
    itself without a mesh or at world size 1."""
    if mesh is None or mesh.world == 1:
        return tensor
    bits = _BITS[tensor.dtype]
    buf = torch.zeros((mesh.world,) + tuple(tensor.shape), dtype=bits, device=tensor.device)
    buf[mesh.rank] = tensor.contiguous().view(bits)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.view(tensor.dtype).reshape((-1,) + tuple(tensor.shape[1:]))


def all_reduce_sum(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``tensor`` over the mesh's ranks, in place, on every
    rank; ``tensor`` untouched without a mesh or at world size 1. Under
    NCCL the reduction is queued on the stream: nothing here waits on the
    host."""
    if mesh is None or mesh.world == 1:
        return tensor
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def agree_max(value: int, mesh) -> int:
    """The largest of every rank's ``value``: one ``all_reduce(MAX)`` of a
    one-element tensor on the rank's device, read on the host."""
    t = torch.full((1,), int(value), dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def barrier(mesh) -> None:
    """Return on each rank only once every rank of ``mesh`` has called it
    (a one-element ``all_reduce`` read on the host); nothing without a
    mesh or at world size 1."""
    if mesh_spans_processes(mesh):
        agree_max(0, mesh)
