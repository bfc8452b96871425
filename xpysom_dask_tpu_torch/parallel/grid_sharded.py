"""Codebook (grid) sharding over ``torch.distributed``: the model axis of
the batch SOM.

Counterpart of ``xpysom_dask_tpu/parallel/grid_sharded.py``. JAX shards
the flattened grid axis ``XY`` of the codebook over a ``'model'`` mesh
axis inside ``shard_map``; the port runs one process per card on a
:class:`~.mesh.GridMesh` of ``n_data × n_model`` processes. Each rank
holds its X-slice of the codebook (``XY / n_model`` contiguous rows) and
the chunks of its data index, and runs the single-device kernels on them:

- **Search**: the shard's searcher is ``core._searcher`` over its rows
  (K1, or the mode's or the activation's kernel). The euclidean and even-p
  searches centre both sides by the mean of the *full* codebook
  (:func:`grid_center`, gathered over the model group), never the shard's
  own: values centred by a shard's mean cannot be compared across shards.
  With the full mean a shard's values are the single-device search's
  values for the same columns. Cosine, manhattan and the other norms need
  no centre.
- **Merge**: an int64 key a row, the value's order-preserving bits above
  the global index (:func:`merge_key`), and ``all_reduce(MIN)`` over the
  model group: the least value, then the least index attaining it
  (first-index ties across shards, as JAX's two ``pmin`` calls keep them).
  The codebook does not change within a call, so every chunk is searched
  first and the keys of all of them are merged in one ``all_reduce``,
  where JAX merges chunk by chunk inside its scan: the same winners, one
  collective a call. :func:`lexmin` is the same merge over a stack of
  candidates, in one process.
- **Statistics**: K9 over the shard's rows, a row whose winner lies on
  another shard at index -1 (K9 skips it), a fresh partial a chunk; the
  epoch's ``[S | cnt]`` all_reduced once over the data group.
- **Update**: ``[S | cnt]`` and the codebook gathered over the model group
  (``fetch_global``, bit for bit), ``core.make_update_fn`` on the full
  codebook, the rank's X-slice kept. This is the one collective an epoch
  whose size grows with XY. The update also returns the new codebook's
  centre, so that the next epoch gathers nothing more.

Every rank of a model group searches and merges every chunk, fully
masked ones included, and every collective runs in the same order on
every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import core
from ..core import SomSpec, grid_coordinates, te_fused_mode
from ..ops.distances import DistanceFunction
from ..ops.kernels import bmu as kbmu
from ..ops.kernels import stats as kstats
from ..utils.profiling import annotate
from .mesh import all_reduce_sum, fetch_global

_F32 = torch.float32
_NO_KEY = torch.iinfo(torch.int64).max

__all__ = [
    "local_rows",
    "local_slice",
    "gather_codebook",
    "grid_center",
    "merge_key",
    "lexmin",
    "make_stats_fn_2d",
    "make_update_fn_2d",
    "make_epoch_fn_2d",
    "make_train_fn_2d",
    "make_bmu_fn_2d",
    "make_quantization_stats_fn_2d",
    "make_topographic_stats_fn_2d",
]


def local_rows(spec: SomSpec, n_model: int) -> int:
    """Codebook rows a model shard holds. The codebook shards along X, so
    each shard's flat rows stay one contiguous range."""
    if spec.x % n_model:
        raise ValueError(f"grid X={spec.x} must divide evenly over {n_model} model shards")
    return spec.xy // n_model


def local_slice(w, mesh):
    """The rank's X-slice of an (X, Y, D) codebook (a view)."""
    xs = w.shape[0] // mesh.n_model
    j = mesh.model.rank
    return w[j * xs : (j + 1) * xs]


def gather_codebook(w_local, mesh):
    """The full (X, Y, D) codebook from every model shard's X-slice, bit for
    bit, on every rank of the model group."""
    return fetch_global(w_local.contiguous(), mesh.model)


def grid_center(w_local, mesh):
    """The mean of the full codebook (``bmu.center_by_mean``): the centre
    every shard's euclidean and even-p searches share, so that their
    values are the single-device search's."""
    w = gather_codebook(w_local, mesh)
    return kbmu.center_by_mean(w.reshape(-1, w.shape[-1]))[0]


def merge_key(vals, idxs):
    """int64 keys that order rows as ``(value, index)``: the value's
    order-preserving int32 bits (``-0.0`` first made ``+0.0``: JAX's float
    compare calls them equal) shifted up 32, OR the non-negative index."""
    bits = (vals.float() + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return (ordered << 32) | idxs.to(torch.int64)


def _split_key(key):
    """``(value f32, index int32)`` of :func:`merge_key`'s keys."""
    ordered = (key >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered)
    return bits.view(_F32), (key & 0xFFFFFFFF).to(torch.int32)


def lexmin(vals, idxs):
    """Per column of a ``(k, N)`` stack of candidates, ``(value, index)``:
    the least value, then the least index among the candidates that reach
    it (JAX's ``_global_bmu`` and ``_lexmin``). The collective merge is
    this function with the stack spread over the model group."""
    return _split_key(torch.amin(merge_key(vals, idxs), dim=0))


def _global_bmu(val, idx, offset, mesh):
    """The global ``(value, index)`` of each row from this shard's
    ``(val, idx)``: one ``all_reduce(MIN)`` of the merge keys over the
    model group; the shard's own at one model shard (offset 0)."""
    if mesh.model.world == 1:
        return val, idx
    key = merge_key(val, idx + offset)
    dist.all_reduce(key, op=dist.ReduceOp.MIN, group=mesh.model.group)
    return _split_key(key)


class _Shard:
    """A rank's side of the sharded search under ``dist_fn``: its flat rows,
    their offset in the full codebook and the searcher over them."""

    def __init__(self, spec: SomSpec, dist_fn: DistanceFunction, mesh, w_local, center=None):
        self.rows = local_rows(spec, mesh.n_model)
        self.offset = mesh.model.rank * self.rows
        self.w = w_local.reshape(self.rows, spec.input_len)
        if center is None and core._centers(dist_fn):
            center = grid_center(w_local, mesh)
        self.spec, self.mesh = spec, mesh
        self.search = core._searcher(spec, dist_fn, self.w, center)

    def winners(self, data):
        """Global flat winners ((C, chunk) int32) of the (C, chunk, D)
        chunks: each chunk searched on this shard, then one merge of every
        chunk's keys."""
        found = [self.search.argmin(data[c], self.spec.use_kernels)
                 for c in range(data.shape[0])]
        idx, val = (torch.stack(t) for t in zip(*found))
        return _global_bmu(val, idx, self.offset, self.mesh)[1]

    def local(self, idx):
        """``idx`` as this shard's row, -1 where another shard holds it."""
        if self.mesh.model.world == 1:
            return idx
        own = idx - self.offset
        return torch.where((own >= 0) & (own < self.rows), own, -1)


def make_stats_fn_2d(spec: SomSpec, mesh, reduce: bool = True):
    """``stats(w_local, data, mask, acc=None, center=None) -> acc``: the
    statistics ``[S | cnt]`` ((XY / n_model, D+1) f32) of this shard's
    rows over the chunks of this rank's data index, added to ``acc`` chunk
    by chunk as fresh partials. ``center`` is the full codebook's
    (:func:`grid_center`; gathered here when None and the search centres).
    ``reduce``: all_reduce the result over the data group (a running
    ``acc`` is then refused: streaming carries it unreduced and reduces
    once)."""
    local_rows(spec, mesh.n_model)
    dist_fn = spec.distance_fn()
    scatter = kstats.scatter_stats if spec.use_kernels else kstats.scatter_stats_plain

    def run(w_local, data, mask, acc=None, center=None):
        if acc is not None and reduce:
            raise ValueError("a running acc is carried unreduced, then reduced once")
        shard = _Shard(spec, dist_fn, mesh, w_local, center)
        if acc is None:
            acc = torch.zeros((shard.rows, spec.input_len + 1), dtype=_F32, device=data.device)
        own = shard.local(shard.winners(data))
        for c in range(data.shape[0]):
            acc = acc + scatter(data[c], mask[c], own[c], shard.rows)
        return all_reduce_sum(acc, mesh.data) if reduce else acc

    return run


def make_update_fn_2d(spec: SomSpec, num_epochs: int, mesh):
    """``update(w_local, acc, t) -> (w_local', center')``: gathers the
    shards' statistics and the codebook over the model group, applies
    ``core.make_update_fn`` to the full codebook (the single-device
    update, on the same bits), keeps this rank's X-slice, and returns with
    it the new codebook's centre where the activation's search centres
    (else None), for the next epoch's statistics."""
    local_rows(spec, mesh.n_model)
    update = core.make_update_fn(spec, num_epochs)
    centers = core._centers(spec.distance_fn())

    def run(w_local, acc, t):
        w = update(gather_codebook(w_local, mesh), fetch_global(acc, mesh.model), t)
        center = kbmu.center_by_mean(w.reshape(spec.xy, spec.input_len))[0] if centers else None
        return local_slice(w, mesh).clone(), center

    return run


def make_epoch_fn_2d(spec: SomSpec, num_epochs: int, mesh):
    """``epoch(w_local, data, mask, t, center=None) -> (w_local',
    center')``: :func:`make_stats_fn_2d` then :func:`make_update_fn_2d`."""
    stats = make_stats_fn_2d(spec, mesh)
    update = make_update_fn_2d(spec, num_epochs, mesh)

    def step(w_local, data, mask, t, center=None):
        return update(w_local, stats(w_local, data, mask, center=center), t)

    return step


def make_train_fn_2d(spec: SomSpec, num_epochs: int, mesh):
    """``train(w_local, data, mask, iter_beg, iter_end, progress=None) ->
    w_local'``: epochs ``[iter_beg, iter_end)`` of :func:`make_epoch_fn_2d`,
    each epoch's centre carried to the next; ``progress(t)`` after each
    epoch ``t``."""
    step = make_epoch_fn_2d(spec, num_epochs, mesh)

    def run(w_local, data, mask, iter_beg, iter_end, progress=None):
        center = None
        for t in range(int(iter_beg), int(iter_end)):
            with annotate("xpysom.epoch"):
                w_local, center = step(w_local, data, mask, t, center)
            if progress is not None:
                progress(t)
        return w_local

    return run


def make_bmu_fn_2d(spec: SomSpec, mesh):
    """``bmu(w_local, data) -> (C, chunk) int32`` global flat winners of
    this rank's chunks, by the activation distance; every rank of a model
    group returns the same ones. The caller gathers them over the data
    group."""
    local_rows(spec, mesh.n_model)
    dist_fn = spec.distance_fn()

    def run(w_local, data):
        return _Shard(spec, dist_fn, mesh, w_local).winners(data)

    return run


def make_quantization_stats_fn_2d(spec: SomSpec, mesh):
    """``qstats(w_local, data, mask) -> (Σ‖x − W[bmu]‖, Σ mask)`` over every
    rank's chunks, BMU by euclidean distance: each shard sums the errors of
    the rows whose winner it holds, then the sum runs over the model
    group, then over the data group."""
    local_rows(spec, mesh.n_model)
    eucl = DistanceFunction("euclidean")

    def run(w_local, data, mask):
        shard = _Shard(spec, eucl, mesh, w_local)
        tot = torch.zeros((), dtype=_F32, device=w_local.device)
        n = torch.zeros((), dtype=_F32, device=w_local.device)
        owns = shard.local(shard.winners(data))
        for c in range(data.shape[0]):
            x, m, own = data[c], mask[c], owns[c]
            mine = (own >= 0).to(_F32)
            err = torch.linalg.vector_norm(x - shard.w[own.clamp(min=0).long()], dim=1)
            tot = tot + torch.sum(err * mine * m)
            n = n + torch.sum(m)
        tot = all_reduce_sum(tot.reshape(1), mesh.model)[0]
        tot, n = all_reduce_sum(torch.stack((tot, n)), mesh.data)
        return tot, n

    return run


def make_topographic_stats_fn_2d(spec: SomSpec, mesh):
    """``tstats(w_local, data, mask) -> (Σ errors, Σ mask)`` over every
    rank's chunks: each shard's top two by euclidean distance (K2 in mode
    ``core.te_fused_mode``, centred by the full codebook's mean), every
    chunk's ``(2, chunk)`` candidates gathered over the model group at
    once, then two :func:`lexmin` passes for the global first and second
    (first-index ties kept); adjacency as
    ``core.make_topographic_stats_fn``."""
    rows = local_rows(spec, mesh.n_model)
    if rows < 2:
        raise ValueError(
            f"topographic_error needs ≥2 codebook rows per model shard "
            f"(got {rows}); use fewer model shards"
        )
    if spec.topology == "hexagonal" and spec.x != spec.y:
        raise ValueError(
            "topographic_error on hexagonal topology requires a square map "
            f"(got {spec.x}x{spec.y}); the reference's coordinate indexing "
            "(xpysom.py:742-743) is undefined for non-square hex maps"
        )
    xx_np, yy_np = grid_coordinates(spec.x, spec.y, spec.topology)
    mode = te_fused_mode(spec)

    def run(w_local, data, mask):
        offset = mesh.model.rank * rows
        w_flat = w_local.reshape(rows, spec.input_len)
        cb = core._codebook(
            spec, lambda: kbmu.PackedCodebook(w_flat, mode, center=grid_center(w_local, mesh)),
            w_flat, data.shape[1])
        xx = torch.as_tensor(xx_np, dtype=_F32, device=w_local.device)
        yy = torch.as_tensor(yy_np, dtype=_F32, device=w_local.device)
        errs = torch.zeros((), dtype=_F32, device=w_local.device)
        n = torch.zeros((), dtype=_F32, device=w_local.device)
        # (2 · n_model, C, chunk) candidates: every shard's first and second
        keys = fetch_global(torch.stack([
            merge_key(torch.stack((v1, v2)), torch.stack((i1, i2)) + offset)
            for i1, v1, i2, v2 in (cb.top2(data[c], spec.use_kernels)
                                   for c in range(data.shape[0]))], dim=1), mesh.model)
        first = torch.amin(keys, dim=0)
        # the first place's candidate out, the least of the rest
        second = torch.amin(torch.where(keys == first, _NO_KEY, keys), dim=0)
        firsts, seconds = _split_key(first)[1], _split_key(second)[1]
        for c in range(data.shape[0]):
            m, i1, i2 = mask[c], firsts[c], seconds[c]
            b1x, b1y = (i1 // spec.y).long(), (i1 % spec.y).long()
            b2x, b2y = (i2 // spec.y).long(), (i2 % spec.y).long()
            if spec.topology == "rectangular":
                bad = (torch.abs(b1x - b2x) > 1) | (torch.abs(b1y - b2y) > 1)
            else:
                dx = xx[b1x, b1y] - xx[b2x, b2y]
                dy = yy[b1x, b1y] - yy[b2x, b2y]
                bad = torch.sqrt(dx * dx + dy * dy) > 1.5
            errs = errs + torch.sum(bad.to(_F32) * m)
            n = n + torch.sum(m)
        errs, n = all_reduce_sum(torch.stack((errs, n)), mesh.data)
        return errs, n

    return run
