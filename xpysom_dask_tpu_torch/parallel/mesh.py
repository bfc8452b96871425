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
- a (data, model) grid (codebook sharding, ``parallel.grid_sharded``): a
  :class:`GridMesh`, a ``(n_data, n_model)`` pair (:func:`make_grid_mesh`
  over the default group) or a ``torch.distributed`` ``DeviceMesh`` whose
  dimensions are named ``('data', 'model')``.

A :class:`GridMesh` lays the world's ``n_data × n_model`` processes out
row-major, rank ``r`` at ``(r // n_model, r % n_model)`` (JAX's
``reshape(n_data, n_model)`` of the device list), and holds two
sub-meshes, each a :class:`DataMesh` of its own group: ``model``, the
ranks of this data index (the codebook's shards), and ``data``, the ranks
of this model index (the data's shards).

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
    "GridMesh",
    "initialize_multihost",
    "make_data_mesh",
    "make_grid_mesh",
    "resolve_mesh",
    "is_grid_mesh",
    "mesh_spans_processes",
    "process_topology",
    "put_with_sharding",
    "fetch_global",
    "all_reduce_sum",
    "barrier",
]


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


@dataclass(frozen=True, eq=False)
class GridMesh:
    """A (data, model) grid of ``n_data × n_model`` processes, one a card:
    ``group`` joins them all (None: the default group, or a world of one
    without ``torch.distributed``), this process's grid ``rank`` at
    ``(rank // n_model, rank % n_model)``, the ``world`` size and the
    process's ``device``; ``model`` is the :class:`DataMesh` of the ranks
    with this data index (its rank is the model index), ``data`` the one of
    the ranks with this model index (its rank is the data index). The
    whole-grid fields let the data mesh's helpers (``barrier``,
    ``agree_max``, ``fetch_global``) run over every rank."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    n_data: int
    n_model: int
    data: DataMesh
    model: DataMesh

    def __repr__(self):
        backend = dist.get_backend(self.group) if dist.is_initialized() else None
        return (
            f"GridMesh(rank={self.rank}, n_data={self.n_data}, n_model={self.n_model}, "
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


# the sub-groups of each grid made so far, keyed by the grid's group (kept
# alive so its id is not reused) and shape: every rank builds the same
# grids in the same order, so every rank finds or makes the same groups
_GRID_GROUPS = {}


def _grid_groups(group, n_data, n_model):
    """``(model_groups, data_groups)`` of a grid over ``group``: one group
    a data index (its ``n_model`` ranks) and one a model index (its
    ``n_data`` ranks), made with ``dist.new_group`` on every rank in the
    same order, once a grid."""
    parent = dist.group.WORLD if group is None else group
    key = (id(parent), n_data, n_model)
    if key not in _GRID_GROUPS:
        members = dist.get_process_group_ranks(parent)
        model = [dist.new_group([members[i * n_model + j] for j in range(n_model)])
                 for i in range(n_data)]
        data = [dist.new_group([members[i * n_model + j] for i in range(n_data)])
                for j in range(n_model)]
        _GRID_GROUPS[key] = (parent, model, data)
    return _GRID_GROUPS[key][1:]


def make_grid_mesh(n_data: int, n_model: int, group=None, device=None) -> GridMesh:
    """The (data, model) grid over ``group`` (default: the default process
    group; a world of 1 when ``torch.distributed`` is not initialized),
    which must hold exactly ``n_data * n_model`` processes, one a card.
    A grid with one row or one column uses ``group`` itself for its long
    side and no group for the other (one rank: no collective runs there).
    A grid with both sizes above one makes its sub-groups with
    ``dist.new_group``, which every rank of the default group enters: it
    is built over the default group, by every rank, in the same order as
    the other grids."""
    n_data, n_model = int(n_data), int(n_model)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"grid ({n_data}, {n_model}): both sizes must be >= 1")
    need = n_data * n_model
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        global_rank = dist.get_rank()
    elif group is not None:
        raise ValueError("a process group needs torch.distributed to be initialized")
    else:
        rank, world, global_rank = 0, 1, 0
    if world != need:
        raise ValueError(
            f"mesh=({n_data}, {n_model}): a grid runs one process per card, so it "
            f"needs {need} processes and its process group has {world}; start "
            f"{need} processes (initialize_multihost, or torchrun "
            f"--nproc-per-node={need})"
        )
    dev = _rank_device(global_rank, device)
    i, j = divmod(rank, n_model)
    whole, alone = DataMesh(group, rank, world, dev), DataMesh(None, 0, 1, dev)
    if n_model == 1:
        return GridMesh(group, rank, world, dev, n_data, 1, data=whole, model=alone)
    if n_data == 1:
        return GridMesh(group, rank, world, dev, 1, n_model, data=alone, model=whole)
    if group is not None and world != dist.get_world_size():
        raise ValueError(
            f"mesh=({n_data}, {n_model}): a grid of both sizes above one is built "
            "over the default process group (every rank enters dist.new_group)")
    model_groups, data_groups = _grid_groups(group, n_data, n_model)
    return GridMesh(group, rank, world, dev, n_data, n_model,
                    data=DataMesh(data_groups[j], i, n_data, dev),
                    model=DataMesh(model_groups[i], j, n_model, dev))


def _grid_of_device_mesh(mesh, device=None) -> GridMesh:
    """A :class:`GridMesh` over a ``DeviceMesh`` named ``('data',
    'model')``, its own sub-groups; its ranks are placed row-major by
    their ``(data, model)`` coordinates."""
    names = tuple(mesh.mesh_dim_names)
    n_data, n_model = (int(mesh.size(names.index(a))) for a in ("data", "model"))
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    members = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    group = None if len(members) == dist.get_world_size() else dist.new_group(members)
    dev = _rank_device(dist.get_rank(), device)
    return GridMesh(group, i * n_model + j, n_data * n_model, dev, n_data, n_model,
                    data=DataMesh(mesh.get_group("data"), i, n_data, dev),
                    model=DataMesh(mesh.get_group("model"), j, n_model, dev))


def is_grid_mesh(mesh) -> bool:
    """True for a (data, model) grid: a :class:`GridMesh`, a pair of
    sizes, or a mesh object whose axis names hold ``'model'`` (a JAX
    ``Mesh``, a torch ``DeviceMesh``)."""
    if isinstance(mesh, GridMesh):
        return True
    if isinstance(mesh, (tuple, list)):
        return len(mesh) == 2
    names = getattr(mesh, "axis_names", None) or getattr(mesh, "mesh_dim_names", None) or ()
    return "model" in names


def resolve_mesh(mesh, device=None):
    """Normalize the user-facing ``mesh`` argument (module docstring) to a
    :class:`DataMesh`, a :class:`GridMesh` or None. ``device`` is this
    process's device (default: its card, :func:`_rank_device`)."""
    if mesh is None or mesh is False:
        return None
    if isinstance(mesh, (DataMesh, GridMesh)):
        return mesh
    if mesh is True or (isinstance(mesh, str) and mesh == "auto"):
        return make_data_mesh(device=device)
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        return make_grid_mesh(*mesh, device=device)
    if is_grid_mesh(mesh):
        if getattr(mesh, "mesh_dim_names", None) is not None and hasattr(mesh, "get_group"):
            if set(mesh.mesh_dim_names) != {"data", "model"}:
                raise ValueError(
                    f"a DeviceMesh grid names its dimensions ('data', 'model'), got "
                    f"{tuple(mesh.mesh_dim_names)}")
            return _grid_of_device_mesh(mesh, device)
        raise TypeError(
            f"cannot interpret mesh argument {mesh!r}: a grid of the port is "
            "make_grid_mesh(n_data, n_model), a (n_data, n_model) pair or a "
            "torch DeviceMesh named ('data', 'model')")
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
