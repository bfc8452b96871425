"""Functional training/inference core of the batch SOM, in PyTorch.

Counterpart of ``xpysom_dask_tpu/core.py``. The algorithm is the same:
per chunk, the BMU search under the activation distance and a scatter of
``[x | 1]`` rows into per-BMU sums ``S`` and counts ``cnt`` (K9); per
epoch, the separable neighborhood operator and the merge
``W' = where(den ≠ 0, num / den, W)``. Where the JAX core runs
``lax.fori_loop``/``lax.scan`` under ``jit``, this core runs Python loops
over epochs and chunks of eager launches.

The BMU search routes as the JAX core's ``_bmu_chunk`` does
(``_kernel_bmu_kind``): euclidean and cosine through the GEMM-form
kernels (K1 in modes ``packed``, ``bf16`` and ``split2``, K3 in
``split3``, K4 in ``highest``, K2 then K1 in ``margin``), manhattan and
odd/fractional-p norm_p through the elementwise kernels (K5–K7), even-p
norm_p through its binomial expansion on K4 (or K1), and the ``_no_opt``
names and ``p <= 0`` through a plain distance matrix.

``SomSpec.use_kernels`` selects the CUDA kernels (True, the default) or
their plain PyTorch versions (False) for tensors on the card; on CPU
tensors the kernel wrappers always run the plain versions.

With a data mesh (``parallel.mesh``, the builders' ``mesh=``) the chunks
are this rank's share: the epoch's statistics are all_reduced once,
where the JAX core ``psum``s them over the ``'data'`` axis, and QE and TE
reduce their two sums.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .ops.decays import DECAY_REGISTRY
from .ops.distances import DistanceFunction
from .ops.kernels import bmu as kbmu
from .ops.kernels import elementwise as kel
from .ops.kernels import stats as kstats
from .ops.kernels import tile as ktile
from .ops.neighborhoods import apply_operator, neighborhood_operator
from .utils.envflags import env_flag
from .utils.profiling import annotate

_F32 = torch.float32

__all__ = [
    "SomSpec",
    "grid_coordinates",
    "chunk_data",
    "make_stats_fn",
    "make_update_fn",
    "make_epoch_step",
    "make_train_fn",
    "make_bmu_fn",
    "make_quantization_stats_fn",
    "make_topographic_stats_fn",
    "te_fused_mode",
]

_MODES = ("packed", "bf16", "split2", "split3", "highest", "margin")


class _FromEnv:
    """Sentinel default of ``SomSpec``'s kernel-config fields: resolve from
    the ``XPYSOM_*`` env switches at construction (the JAX package's
    ``core.FROM_ENV``). Never survives ``__post_init__``."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "FROM_ENV"


FROM_ENV = _FromEnv()


@dataclass(frozen=True)
class SomSpec:
    """Static SOM configuration (the reference constructor surface); the
    codebook lives outside. ``bmu_precision`` is validated against the
    JAX package's modes and resolved as it resolves them: ``None`` means
    ``'highest'`` for norm_p (its expansion cancels below exact
    precision) and ``'packed'`` otherwise. Every mode is served.

    Omitted kernel-config fields (the ``FROM_ENV`` default) are read from
    the env switches ONCE, here, as the JAX ``SomSpec`` reads them:
    ``XPYSOM_BMU_PRECISION`` (an unknown value warns and keeps the
    default; under norm_p a value other than ``'highest'`` warns and keeps
    ``'highest'``) and ``XPYSOM_TPU_NO_PALLAS`` (a truthy value means
    ``use_kernels=False``: the plain versions, as it means the plain-XLA
    formulation in JAX). A concrete value, ``None`` included, is
    env-blind. ``XPYSOM_BMU_TILES`` is TPU-only: the port's kernels take
    no tiles."""

    x: int
    y: int
    input_len: int
    sigma: float
    sigmaN: float
    learning_rate: float
    learning_rateN: float
    decay: str = "exponential"
    neighborhood: str = "gaussian"
    std_coeff: float = 0.5
    topology: str = "rectangular"
    distance: str = "euclidean"
    distance_kwargs: Tuple[Tuple[str, object], ...] = ()
    compact_support: bool = False
    bmu_precision: object = FROM_ENV  # None = 'highest' for norm_p, else 'packed'
    use_kernels: object = FROM_ENV  # None = True

    def __post_init__(self):
        default = "highest" if self.distance == "norm_p" else "packed"
        if self.use_kernels is FROM_ENV:
            object.__setattr__(self, "use_kernels", not env_flag("XPYSOM_TPU_NO_PALLAS"))
        if self.bmu_precision is FROM_ENV:
            mode = kbmu.env_mode(default)
            if self.distance == "norm_p" and mode != "highest":
                # a process-wide env var set for a euclidean experiment
                # must not degrade norm_p's exactness; only an explicit
                # bmu_precision= may
                warnings.warn(
                    f"XPYSOM_BMU_PRECISION={mode!r} ignored for norm_p "
                    "activations (the binomial expansion cancels below "
                    "exact precision); using 'highest' — pass "
                    "bmu_precision= explicitly to override"
                )
                mode = "highest"
        elif self.bmu_precision is None:
            mode = default
        else:
            mode = str(self.bmu_precision).lower()
            if mode not in _MODES:
                raise ValueError(
                    f"bmu_precision={self.bmu_precision!r} not recognized "
                    "(packed|bf16|split2|split3|highest|margin)"
                )
            if mode == "margin" and self.distance == "norm_p":
                raise ValueError(
                    "bmu_precision='margin' is not supported with norm_p "
                    "activations (the expansion's cancellation defeats the "
                    "margin gate); use 'highest'"
                )
        object.__setattr__(self, "bmu_precision", mode)
        object.__setattr__(
            self, "use_kernels", True if self.use_kernels is None else bool(self.use_kernels)
        )

    @property
    def xy(self) -> int:
        return self.x * self.y

    def distance_fn(self) -> DistanceFunction:
        return DistanceFunction(self.distance, dict(self.distance_kwargs))


def grid_coordinates(x: int, y: int, topology: str):
    """Euclidean grid coordinate meshes ``(xx, yy)`` of shape ``(y, x)``
    with the hexagonal row offset ``xx[::-2] -= 0.5``."""
    xx, yy = np.meshgrid(np.arange(x), np.arange(y))
    xx = xx.astype(np.float64)
    yy = yy.astype(np.float64)
    if topology == "hexagonal":
        xx[::-2] -= 0.5
    return xx, yy


def chunk_data(
    data: np.ndarray, chunk: int, multiple_of: int = 1, min_chunks: int = 1
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad + reshape ``(N, D)`` data into ``(C, chunk, D)`` chunks and a
    ``(C, chunk)`` float32 validity mask."""
    n, d = data.shape
    c = max(min_chunks, -(-n // chunk))
    c = -(-c // multiple_of) * multiple_of
    total = c * chunk
    padded = np.zeros((total, d), dtype=np.float32)
    padded[:n] = data
    mask = np.zeros((total,), dtype=np.float32)
    mask[:n] = 1.0
    return padded.reshape(c, chunk, d), mask.reshape(c, chunk), n


def _kernel_bmu_kind(dist: DistanceFunction, use_kernels: bool = True):
    """Which kernel route serves this activation: ``'euclidean'`` /
    ``'cosine'`` (GEMM form: K1 or K4 by mode), ``'norm_p_even'`` (its
    binomial expansion on the GEMM form), ``'manhattan'`` /
    ``'norm_p_odd'`` / ``'norm_p_frac'`` (K5 / K6 / K7), or None (the plain
    distance matrix + argmin: no kernel). Counterpart of the JAX core's
    ``_pallas_bmu_kind``.

    Bounds kept, and why:
      * ``use_kernels=False`` → None, as ``use_pallas=False`` is in JAX.
        (``_bmu_chunk`` does not ask this: with ``use_kernels=False`` it
        runs each route's plain versions, so kernel and plain runs search
        the same way. The model asks it to size its default chunk.)
      * the ``_no_opt`` names → None: they name the reference's unoptimized
        path.
      * norm_p: even p ≥ 2 → the expansion; odd p ≥ 1 → K6; non-integer
        p > 0 → K7; p ≤ 0 → None (no expansion exists and the kernels'
        terms assume p > 0; the matrix path computes them through pow).
        Integer-valued floats count as integers.
    Bounds dropped: the JAX gate's ``_PALLAS_MAX_D = 2048``,
    ``_PALLAS_MANHATTAN_MAX_D = 256`` and ``_ELEMENTWISE_UNROLL_BUDGET``
    are Mosaic limits (VMEM size, a trace-time unroll). The CUDA kernels
    loop over d and over the p chain at run time with fixed shared-memory
    tiles, so no width or p bound applies and the gate, unlike the JAX
    one, takes no feature width. Operands beyond 32-bit sizes raise in the
    wrappers."""
    if not use_kernels:
        return None
    if dist.name in ("euclidean", "cosine", "manhattan"):
        return dist.name
    if dist.name == "norm_p":
        p = dist.kwargs.get("p", 2)
        if float(p).is_integer():
            ip = int(p)
            if ip >= 2 and ip % 2 == 0:
                return "norm_p_even"
            if ip >= 1 and ip % 2 == 1:
                return "norm_p_odd"
        elif float(p) > 0:
            return "norm_p_frac"
    return None


class _MatrixSearch:
    """The route without a kernel: the (N, XY) distance matrix of the
    activation, then the first-index argmin (the JAX package's XLA
    path)."""

    def __init__(self, dist: DistanceFunction, w_flat):
        self.dist = dist
        self.w = w_flat.float()
        self.w_sq = torch.sum(self.w * self.w, dim=1, keepdim=True) if dist.can_cache else None

    def argmin(self, x, use_kernels=True):
        return ktile.first_argmin(self.dist.flat(x, self.w, self.w_sq))


def _centers(dist: DistanceFunction) -> bool:
    """True where the search under ``dist`` centres both sides by a mean
    (the euclidean GEMM form and the even-p expansion)."""
    return _kernel_bmu_kind(dist) in ("euclidean", "norm_p_even")


def _searcher(spec: SomSpec, dist: DistanceFunction, w_flat, center=None, rows=None):
    """The codebook side of the BMU search under ``dist``, built once per
    epoch (or scoring call) and shared by every chunk: an object with
    ``argmin(x, use_kernels) -> (idx, val)``. The routes of the JAX core's
    ``_bmu_chunk``; ``dist`` is passed apart from the spec because QE
    searches by euclidean distance whatever the activation, under the
    spec's mode. ``center`` (a (D,) tensor) replaces the codebook's own
    mean where the search centres (:func:`_centers`): a codebook shard
    passes the full codebook's. Built in an ``xpysom.codebook`` span
    (:func:`_codebook`); ``rows``, the rows of a chunk, names the feed."""
    kind = _kernel_bmu_kind(dist)
    mode = spec.bmu_precision
    own = True if center is None else center

    def build():
        if kind == "euclidean":
            return kbmu.PackedCodebook(w_flat, mode, center=own)
        if kind == "cosine":
            return kbmu.cosine_codebook(w_flat, mode)
        if kind == "norm_p_even":
            return kbmu.NormPEvenCodebook(w_flat, dist.kwargs.get("p", 2), mode, center=own)
        if kind == "manhattan":
            return kel.ElementwiseCodebook(w_flat, kind)
        if kind in ("norm_p_odd", "norm_p_frac"):
            # no default p: the gate routes here only for an explicit odd or
            # non-integer p
            return kel.ElementwiseCodebook(w_flat, kind, dist.kwargs["p"])
        return _MatrixSearch(dist, w_flat)

    return _codebook(spec, build, w_flat, rows)


def _codebook(spec: SomSpec, build, w_flat, rows=None):
    """``build()``, the search's side of the codebook ``w_flat``, in an
    ``xpysom.codebook`` span: its normalisation or centring and packing,
    and on the card the layout the kernels read (``laid()``), made here
    once and not at the first chunk. The span counts ``units`` and, where
    K1 or K2 search the codebook in chunks of ``rows`` rows, the packed
    operand's padded ``depth`` and the ``feed`` that ``kbmu.search_feed``
    picks (``kbmu.FEED_STREAMED``, ``FEED_PAIRS`` or ``FEED_REGISTERS``)."""
    with annotate("xpysom.codebook", units=w_flat.shape[0]) as span:
        search = build()
        packed = getattr(search, "_gemm", search)  # the norm_p expansion's codebook
        if (spec.use_kernels and w_flat.device.type == "cuda" and hasattr(packed, "laid")
                and getattr(packed, "mode", None) != "highest"):  # K4 reads no layout
            packed.laid()
        fed = packed.search_feed(rows) if rows and isinstance(packed, kbmu.PackedCodebook) else None
        if fed is not None:
            span.add(depth=fed[0], feed=fed[1])
    return search


def _bmu_chunk(spec: SomSpec, search, x):
    """Flat BMU indices (int32) of one chunk through ``search``
    (``_searcher``): the kernel, or its plain version when
    ``spec.use_kernels`` is False."""
    idx, _ = search.argmin(x, spec.use_kernels)
    return idx


def _accumulate_stats(spec: SomSpec, search, data, mask, acc=None):
    """The running per-BMU statistics ``acc = [S | cnt]`` (an (XY, D+1)
    f32 tensor; zeros when None) plus those of every chunk, chunk by chunk
    as ``acc + partial``.

    Each chunk scatters into a *fresh* partial that is then added to the
    running total: scattering +1.0 rows straight into a large f32 total
    drops increments once a node's count passes 2^24."""
    scatter = kstats.scatter_stats if spec.use_kernels else kstats.scatter_stats_plain
    if acc is None:
        acc = torch.zeros((spec.xy, data.shape[-1] + 1), dtype=_F32, device=data.device)
    for c in range(data.shape[0]):
        x, m = data[c], mask[c]
        acc = acc + scatter(x, m, _bmu_chunk(spec, search, x), spec.xy)
    return acc


def _neighborhood_op(spec: SomSpec, sigma):
    device = sigma.device
    return neighborhood_operator(
        spec.neighborhood,
        spec.topology,
        torch.arange(spec.x, dtype=_F32, device=device),
        torch.arange(spec.y, dtype=_F32, device=device),
        spec.std_coeff,
        spec.compact_support,
        sigma,
    )


def _update_from_stats(spec: SomSpec, w_flat, s, cnt, eta, sigma):
    """Neighborhood-smoothed codebook update from the statistics:
    ``W' = where(den ≠ 0, num / den, W)``; ``eta`` scales num and den."""
    op = _neighborhood_op(spec, sigma)
    num, den = apply_operator(op, s, cnt)
    num = num * eta
    den = (den * eta)[:, None]
    return torch.where(den != 0, num / den, w_flat)


def _decays(spec: SomSpec, t, num_epochs: int, device):
    decay = DECAY_REGISTRY[spec.decay]
    # a fill kernel, not torch.tensor's copy from pageable host memory: that
    # copy waits for the stream, which after an epoch's statistics would
    # idle the card while the host builds the update
    t = torch.full((), int(t), dtype=torch.int32, device=device)
    eta = decay(spec.learning_rate, spec.learning_rateN, t, num_epochs)
    sig = decay(spec.sigma, spec.sigmaN, t, num_epochs)
    return eta, sig


def _all_reduce_sum(tensor, mesh):
    """``parallel.mesh.all_reduce_sum`` (imported here, at the call: the
    ``parallel`` package imports this module)."""
    from .parallel.mesh import all_reduce_sum

    return all_reduce_sum(tensor, mesh)


def make_stats_fn(spec: SomSpec, mesh=None):
    """``stats(w, data, mask, acc=None) -> acc``: the first half of an
    epoch. Adds the per-BMU statistics of the (C, chunk, D)/(C, chunk)
    chunks under the (X, Y, D) codebook ``w`` to the running ``acc =
    [S | cnt]`` ((XY, D+1) f32; None starts from zeros) and returns it.
    Carrying ``acc`` across calls adds the chunks' partials in one order
    and association whatever calls they arrive in, so an epoch streamed in
    superbatches of whole chunks equals the resident epoch bit for bit.

    With a data mesh (``parallel.mesh``) the chunks are this rank's share
    and the result is the sum over the ranks: this rank's total, then one
    ``all_reduce`` of it, which gives every rank the same bits; with K9's
    deterministic scatter (no float atomics: never ``index_add_`` here)
    every rank then updates alike. The counts stay f32, as the JAX package
    psums them: exact up to 2^24 rows a node over all ranks. A running
    total is this rank's own, so ``acc`` is refused: streaming carries it
    without the mesh and reduces once
    (``parallel.pipeline.stats_streaming``)."""
    dist = spec.distance_fn()

    def run(w, data, mask, acc=None):
        if acc is not None and mesh is not None:
            raise ValueError("a running acc is carried without a mesh, then reduced once")
        search = _searcher(spec, dist, w.reshape(spec.xy, spec.input_len), rows=data.shape[1])
        return _all_reduce_sum(_accumulate_stats(spec, search, data, mask, acc), mesh)

    return run


def make_update_fn(spec: SomSpec, num_epochs: int):
    """``update(w, acc, t) -> w'``: the second half of an epoch, the
    decays of epoch ``t`` of a ``num_epochs`` schedule, the neighborhood
    operator and the merge, from the statistics ``acc = [S | cnt]``."""

    def run(w, acc, t):
        w_flat = w.reshape(spec.xy, spec.input_len)
        eta, sig = _decays(spec, t, num_epochs, w.device)
        s, cnt = acc[:, : spec.input_len], acc[:, spec.input_len]
        return _update_from_stats(spec, w_flat, s, cnt, eta, sig).reshape(w.shape)

    return run


def make_epoch_step(spec: SomSpec, num_epochs: int, mesh=None):
    """``step(w, data, mask, t) -> w'`` for one epoch: ``make_stats_fn``
    then ``make_update_fn``. ``w`` is the (X, Y, D) f32 codebook,
    ``data``/``mask`` the (C, chunk, D)/(C, chunk) chunks, ``t`` the epoch
    index of a ``num_epochs`` schedule. With a data mesh, ``data`` is this
    rank's share and every rank updates from the same reduced
    statistics."""
    stats = make_stats_fn(spec, mesh)
    update = make_update_fn(spec, num_epochs)

    def step(w, data, mask, t):
        return update(w, stats(w, data, mask), t)

    return step


def make_train_fn(spec: SomSpec, num_epochs: int, mesh=None):
    """``train(w, data, mask, iter_beg, iter_end, progress=None) -> w'``:
    epochs ``[iter_beg, iter_end)`` of a ``num_epochs`` schedule, the
    decays computed from each epoch index; ``progress(t)`` is called after
    each epoch ``t``. ``mesh``: as ``make_epoch_step``."""
    step = make_epoch_step(spec, num_epochs, mesh)

    def run(w, data, mask, iter_beg, iter_end, progress=None):
        for t in range(int(iter_beg), int(iter_end)):
            with annotate("xpysom.epoch"):
                w = step(w, data, mask, t)
            if progress is not None:
                progress(t)
        return w

    return run


def make_bmu_fn(spec: SomSpec, mesh=None):
    """``bmu(w, data) -> (C, chunk) int32`` flat grid indices, by the
    activation distance. Each row's winner needs no other rank, so with a
    data mesh this returns this rank's winners; the caller gathers them
    (``parallel.mesh.fetch_global``)."""
    dist = spec.distance_fn()

    def run(w, data):
        search = _searcher(spec, dist, w.reshape(spec.xy, spec.input_len), rows=data.shape[1])
        return torch.stack([_bmu_chunk(spec, search, data[c]) for c in range(data.shape[0])])

    return run


def make_quantization_stats_fn(spec: SomSpec, mesh=None):
    """``qstats(w, data, mask) -> (Σ‖x - W[bmu]‖, Σ mask)``, BMU by
    euclidean distance whatever the activation (the reference's
    definition), searched under the spec's mode. With a data mesh both
    sums are over every rank's chunks (one ``all_reduce``)."""
    eucl = DistanceFunction("euclidean")

    def run(w, data, mask):
        w_flat = w.reshape(spec.xy, spec.input_len)
        search = _searcher(spec, eucl, w_flat, rows=data.shape[1])
        tot = torch.zeros((), dtype=_F32, device=w.device)
        n = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            bmu = _bmu_chunk(spec, search, x)
            err = torch.linalg.vector_norm(x - w_flat[bmu.long()], dim=1)
            tot = tot + torch.sum(err * m)
            n = n + torch.sum(m)
        if mesh is not None:
            tot, n = _all_reduce_sum(torch.stack((tot, n)), mesh)
        return tot, n

    return run


def te_fused_mode(spec: SomSpec) -> str:
    """Precision mode of TE's top-2 search (the JAX core's
    ``te_fused_mode``): TE is exact by contract like training, so every
    mode but ``'bf16'`` maps onto the exact packed split (``'margin'``
    exists to be exact; ``'split2'``, ``'split3'`` and ``'highest'`` are
    exact by other means); ``'bf16'`` stays opt-in."""
    return "bf16" if spec.bmu_precision == "bf16" else "packed"


def make_topographic_stats_fn(spec: SomSpec, mesh=None):
    """``tstats(w, data, mask) -> (Σ errors, Σ mask)``: top-2 BMUs by
    euclidean distance (K2 in mode ``te_fused_mode(spec)``), an error where
    they are not adjacent: ``|Δx| > 1 or |Δy| > 1`` on the rectangular
    grid, a euclidean offset distance ``> 1.5`` on the hexagonal one. The
    hexagonal branch indexes the ``(y, x)``-shaped coordinate meshes with
    ``[bx, by]`` as the JAX core and the reference do, which is only
    self-consistent for square maps; others raise. With a data mesh both
    sums are over every rank's chunks (one ``all_reduce``)."""
    if spec.topology == "hexagonal" and spec.x != spec.y:
        raise ValueError(
            "topographic_error on hexagonal topology requires a square map "
            f"(got {spec.x}x{spec.y})"
        )
    xx_np, yy_np = grid_coordinates(spec.x, spec.y, spec.topology)
    mode = te_fused_mode(spec)

    def run(w, data, mask):
        w_flat = w.reshape(spec.xy, spec.input_len)
        cb = _codebook(spec, lambda: kbmu.PackedCodebook(w_flat, mode), w_flat, data.shape[1])
        xx = torch.as_tensor(xx_np, dtype=_F32, device=w.device)
        yy = torch.as_tensor(yy_np, dtype=_F32, device=w.device)
        errs = torch.zeros((), dtype=_F32, device=w.device)
        n = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            i1, _, i2, _ = cb.top2(x, spec.use_kernels)
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
        if mesh is not None:
            errs, n = _all_reduce_sum(torch.stack((errs, n)), mesh)
        return errs, n

    return run
