"""Population training: P same-shape SOMs behind one model-selection API.

Counterpart of ``xpysom_dask_tpu/models/population.py``. Train many maps
that differ only in random seed, σ schedule or learning-rate schedule,
then keep the one with the lowest quantization error. The strategies,
selected by ``train(strategy=...)``, compute the same per-member math:

- ``'serial'`` and ``'fused'`` (``'auto'`` chooses them): per member the
  single-model epoch, the statistics of ``core.make_stats_fn`` (K1 + K9
  under the default euclidean activation) with a running ``[S | cnt]`` per
  member, stacked to ``(P, XY, D+1)``, then the member's
  ``core.make_update_fn``. That is ``core.make_epoch_step``, what a lone
  ``XPySom`` trains with, on one device-resident copy of chunks of the
  member's own size, so a sweep equals training each member alone bit for
  bit. ``'serial'`` is the JAX package's name for the resident sweep and
  refuses streamed sources there; ``'fused'`` serves every member from
  one pass over a streamed source.
- ``'batched'``: the stacked ``(P·XY, D)`` codebook searched by one
  concatenated fp32 GEMM per chunk (``DistanceFunction.flat`` under
  ``fp32_matmul``), a first-index argmin per member over its
  ``(chunk, P, XY)`` view, and K9 per member into a fresh per-chunk
  partial that is added to the running total. In the JAX package this is
  XLA glue outside any Pallas kernel, so the GEMM and the block argmin
  are plain torch here; K1 finds one global argmin, not one per member.

Where the JAX package compiles whole sweeps under ``jit``, this module
runs Python loops of eager launches over epochs, members and chunks; there
is no program to cache. Per-member knobs: ``random_seed``, ``sigma``,
``sigmaN``, ``learning_rate``, ``learning_rateN`` (a scalar is shared, a
length-P sequence is per member); everything else is shared. Members are
real ``XPySom`` objects on the population's device.
"""

from __future__ import annotations

from typing import Sequence
from warnings import warn

import numpy as np
import torch

from .. import core
from ..ops.distances import (
    euclidean_squared_distance_part,
    fp32_matmul,
    manhattan_distance_no_opt,
)
from ..ops.kernels import stats as kstats
from ..ops.kernels import tile as ktile
from ..parallel.pipeline import (
    default_superbatch_rows,
    device_superbatches,
    stats_streaming,
)
from ..utils import serialization
from ..utils.hw import default_n_parallel, resolve_device, training_chunk
from ..utils.progress import ProgressReporter
from .som import XPySom, _as_numpy_2d, _not_ported

__all__ = ["SomPopulation"]

_F32 = torch.float32

# Streamed 'auto' runs 'fused' at every size. Measured by chip_smoke.py's
# population phase on one NVIDIA H100 80GB HBM3 at 700 W (streamed epoch of
# every member, CUDA events, median of 3, two runs): 16 maps of 24x24x16 on
# 2^17 rows (9,216 stacked nodes) fused 58.007 / 78.9 ms, batched 158.951 /
# 122.0 ms; 4 maps of 128x128x64 on 2^19 rows (65,536 stacked nodes) fused
# 116.320 / 63.0 ms, batched 698.980 / 984.9 ms. Larger sweeps are not
# measured; batched's chunk shrinks as 2^24 / (P·XY) rows there. The JAX
# package's gate (batched above 32,768 stacked nodes) is a TPU measurement.


def _block_argmin(flat, x, w_big, w_sq, n_pop: int):
    """(P, chunk) int32 winners of the (chunk, D) samples ``x`` in every
    member of the stacked (P·XY, D) codebook ``w_big``: the concatenated
    distance matrix ``flat(x, w_big, w_sq)`` in fp32 (TF32 off), then the
    first-index argmin within each member's block of XY columns."""
    with fp32_matmul():
        dmat = flat(x, w_big, w_sq)
    bmu, _ = ktile.first_argmin(dmat.reshape(x.shape[0] * n_pop, -1))
    return bmu.reshape(x.shape[0], n_pop).T.contiguous()


def _make_pop_stats(specs):
    """The concatenated-codebook statistics of strategy ``'batched'``:
    ``stats(w, data, mask, acc=None) -> acc``, ``w`` the (P, XY, D)
    codebooks, ``acc`` the running (P, XY, D+1) ``[S | cnt]`` (None starts
    from zeros), the shape of ``core.make_stats_fn``."""
    spec0 = specs[0]
    n_pop, xy, d_dim = len(specs), spec0.xy, spec0.input_len
    dist = spec0.distance_fn()
    flat = dist.flat
    if dist.name == "manhattan" and not spec0.use_kernels:
        flat = lambda x, w, w_sq: manhattan_distance_no_opt(x, w)  # K8's plain version
    scatter = kstats.scatter_stats if spec0.use_kernels else kstats.scatter_stats_plain

    def stats(w, data, mask, acc=None):
        w_big = w.reshape(n_pop * xy, d_dim)
        w_sq = torch.sum(w_big * w_big, dim=1, keepdim=True) if dist.can_cache else None
        if acc is None:
            acc = torch.zeros((n_pop, xy, d_dim + 1), dtype=_F32, device=w.device)
        accs = list(acc.unbind(0))
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            bmu = _block_argmin(flat, x, w_big, w_sq, n_pop)
            for p in range(n_pop):
                # a fresh partial per member and chunk, then the running
                # total: +1.0 scattered straight into a large f32 total
                # would drop counts past 2^24
                accs[p] = accs[p] + scatter(x, m, bmu[p], xy)
        return torch.stack(accs)

    return stats


def _make_pop_stats_fused(specs):
    """The per-member statistics of strategy ``'fused'``: per member the
    single-model body ``core.make_stats_fn`` with that member's running
    ``acc``, stacked; the shape of :func:`_make_pop_stats`."""
    fns = [core.make_stats_fn(s) for s in specs]

    def stats(w, data, mask, acc=None):
        return torch.stack(
            [fn(w[i], data, mask, None if acc is None else acc[i]) for i, fn in enumerate(fns)]
        )

    return stats


def _pop_update(specs, num_epochs: int):
    """``update(w, acc, t) -> w'``: per member ``core.make_update_fn`` (the
    member's decays from a fill kernel, its neighborhood operator, the
    merge)."""
    fns = [core.make_update_fn(s, num_epochs) for s in specs]

    def update(w, acc, t):
        return torch.stack([fn(w[i], acc[i], t) for i, fn in enumerate(fns)])

    return update


def make_population_qe_fn(spec0, n_pop: int):
    """``qstats(w, data, mask) -> (Σ‖x − W_p[bmu_p]‖ per member (P,),
    Σ mask)``: the BMU by euclidean distance whatever the activation (the
    reference's definition), every member searched by one concatenated
    fp32 GEMM per chunk."""
    xy = spec0.xy

    def run(w, data, mask):
        w_big = w.reshape(n_pop * xy, spec0.input_len)
        w_sq = torch.sum(w_big * w_big, dim=1, keepdim=True)
        members = torch.arange(n_pop, device=w.device)[:, None]
        tot = torch.zeros((n_pop,), dtype=_F32, device=w.device)
        n = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            bmu = _block_argmin(euclidean_squared_distance_part, x, w_big, w_sq, n_pop)
            res = x[None] - w[members, bmu.long()]  # (P, chunk, D)
            tot = tot + torch.sum(torch.linalg.vector_norm(res, dim=2) * m[None], dim=1)
            n = n + torch.sum(m)
        return tot, n

    return run


def _first_superbatch(src):
    """The first superbatch of ``src`` (at most 65,536 rows), a bounded,
    deterministic sample for the verbose quantization errors; None for an
    empty or exhausted one-shot source."""
    try:
        sample = next(iter(src.superbatches(min(len(src), 65536))))
    except (StopIteration, ValueError):
        return None
    return sample if len(sample) else None


def _broadcast(value, n, name):
    """Scalar → length-n list; sequence → validated length-n list."""
    if np.ndim(value) == 0:
        return [value] * n
    seq = list(value)
    if len(seq) != n:
        raise ValueError(
            f"{name} must be a scalar or a length-{n} sequence, got length {len(seq)}"
        )
    return seq


class SomPopulation:
    """P same-shape SOMs trained together.

    Per-member arguments (``sigma``, ``sigmaN``, ``learning_rate``,
    ``learning_rateN``, ``random_seed``) accept a scalar (shared) or a
    length-``n_members`` sequence. An int ``random_seed`` seeds member i
    with ``random_seed + i``. All other arguments match ``XPySom`` and are
    shared. ``device`` is where every member computes (default: the card,
    ``RuntimeError`` without one; ``'cpu'`` for the CPU). ``mesh=``
    (data-parallel training) is not ported yet.

    Typical model-selection sweep::

        pop = SomPopulation(16, 24, 24, d, sigma=sigmas, random_seed=0)
        pop.train(data, 10)
        som = pop.best(data)        # lowest-QE member, a normal XPySom
    """

    def __init__(
        self,
        n_members,
        x,
        y,
        input_len,
        sigma=0,
        sigmaN=1,
        learning_rate=0.5,
        learning_rateN=0.01,
        decay_function="exponential",
        neighborhood_function="gaussian",
        std_coeff=0.5,
        topology="rectangular",
        activation_distance="euclidean",
        activation_distance_kwargs={},
        random_seed=None,
        n_parallel=0,
        compact_support=False,
        mesh=None,
        device=None,
    ):
        if not isinstance(n_members, (int, np.integer)) or n_members < 1:
            raise ValueError(f"n_members must be a positive int, got {n_members!r}")
        if mesh is not None:
            _not_ported("SomPopulation(mesh=...) (data-parallel population training)", 8)
        self._n_members = int(n_members)

        sigmas = _broadcast(sigma, n_members, "sigma")
        sigmaNs = _broadcast(sigmaN, n_members, "sigmaN")
        lrs = _broadcast(learning_rate, n_members, "learning_rate")
        lrNs = _broadcast(learning_rateN, n_members, "learning_rateN")
        if random_seed is None or np.ndim(random_seed) == 0:
            seeds = [None if random_seed is None else int(random_seed) + i
                     for i in range(n_members)]
        else:
            seeds = _broadcast(random_seed, n_members, "random_seed")

        # the device as the caller gave it and as resolved here; a pickle
        # keeps the first and resolves it again on the loading host
        self._device_arg = device
        self._resolved_device = resolve_device(device)

        # 'batched' builds the concatenated (chunk, P·XY) distance matrix,
        # so the population's chunk is budgeted against it. Members keep
        # the user's value: auto-sized members size themselves as a lone
        # XPySom does, which 'serial' and 'fused' train with
        self._n_parallel_explicit = n_parallel != 0
        member_n_parallel = n_parallel
        if n_parallel == 0:
            n_parallel = default_n_parallel(
                self._n_members * x * y, self._device.type, fused=False
            )
        self._members_list = [
            XPySom(
                x,
                y,
                input_len,
                sigma=sigmas[i],
                sigmaN=sigmaNs[i],
                learning_rate=lrs[i],
                learning_rateN=lrNs[i],
                decay_function=decay_function,
                neighborhood_function=neighborhood_function,
                std_coeff=std_coeff,
                topology=topology,
                activation_distance=activation_distance,
                activation_distance_kwargs=activation_distance_kwargs,
                random_seed=seeds[i],
                n_parallel=member_n_parallel,
                compact_support=compact_support,
                device=device,
            )
            for i in range(n_members)
        ]
        self._x, self._y, self._input_len = x, y, input_len
        self._n_parallel = int(n_parallel)

    @classmethod
    def from_numpy(cls, weights, **kwargs):
        """A population whose member codebooks are ``weights``, a
        (P, X, Y, D) array (e.g. a JAX population's ``weights``);
        ``kwargs`` are constructor arguments."""
        weights = np.asarray(weights)
        if weights.ndim != 4:
            raise ValueError(f"(P, X, Y, D) weights expected, got {weights.shape}")
        pop = cls(*weights.shape, **kwargs)
        for m, w in zip(pop._members_list, weights):
            m._weights = w.copy()
        return pop

    # -- population state ----------------------------------------------------

    @property
    def _device(self) -> torch.device:
        if self._resolved_device is None:
            self._resolved_device = resolve_device(self._device_arg)
        return self._resolved_device

    @property
    def n_members(self) -> int:
        return self._n_members

    @property
    def members(self) -> Sequence[XPySom]:
        """The live member models (views, not copies)."""
        return list(self._members_list)

    def member(self, i: int) -> XPySom:
        return self._members_list[i]

    @property
    def weights(self) -> np.ndarray:
        """Stacked member codebooks, shape ``(P, X, Y, D)``."""
        return np.stack([np.asarray(m._weights, dtype=np.float32) for m in self._members_list])

    def _specs(self):
        return tuple(m._spec for m in self._members_list)

    def _stacked_device_weights(self):
        """The (P, XY, D) codebooks on the device: one upload."""
        w = self.weights.reshape(self._n_members, self._x * self._y, self._input_len)
        return torch.from_numpy(w).to(self._device)

    def _write_back(self, w):
        w_host = w.cpu().numpy()
        for i, m in enumerate(self._members_list):
            m._weights = w_host[i].reshape(self._x, self._y, self._input_len)

    def _chunk_budget(self, strategy: str) -> int:
        """The chunk budget of a strategy: ``'batched'`` builds the
        concatenated (chunk, P·XY) matrix and takes the population's;
        ``'serial'`` and ``'fused'`` run the single-model search and take
        the member's (the same for every member)."""
        if strategy == "batched":
            return self._n_parallel
        return self._members_list[0]._n_parallel

    @staticmethod
    def _stream_chunk(rows: int, n: int, budget: int) -> int:
        """The chunk of a streamed call: the resident rule applied to one
        superbatch, or to the whole source where it is shorter (a source
        that fits one superbatch is then chunked as resident data is, not
        padded to a superbatch's chunk)."""
        return training_chunk(min(rows, max(n, 1)), budget)

    def _superbatch_rows(self) -> int:
        """~256 MB device-resident blocks — the pipeline's shared rule."""
        return default_superbatch_rows(self._input_len)

    # -- training / evaluation ------------------------------------------------

    def train(
        self,
        data,
        num_epochs,
        iter_beg=0,
        iter_end=None,
        verbose=False,
        checkpoint_path=None,
        checkpoint_every=0,
        strategy="auto",
    ):
        """Train every member on ``data`` for epochs ``[iter_beg, iter_end)``
        of a ``num_epochs`` schedule.

        ``strategy``: ``'serial'`` and ``'fused'`` (per member the
        single-model epoch, the same bits as training it alone;
        ``'serial'`` refuses streamed sources), ``'batched'`` (the
        concatenated-codebook search), or ``'auto'`` (default):
        ``'serial'`` for resident data, ``'fused'`` for streamed sources.
        ``'batched'`` searches in fp32 and may flip near-tie winners, so
        compare it with the others by quantization error.

        Source-like ``data`` (anything with ``superbatches`` or an
        ``np.memmap``) streams through the device in superbatches; with
        superbatches of whole chunks a streamed sweep equals the resident
        one bit for bit. ``checkpoint_path`` + ``checkpoint_every=k`` write
        a population ``.npz`` every k epochs and at the end; after a
        failure, ``SomPopulation.load_checkpoint(path)`` and ``train(data,
        num_epochs, iter_beg=pop._checkpoint_epoch)`` resume. ``verbose``
        prints a progress bar and, at the end, the quantization errors
        (of the first superbatch for streamed data)."""
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every={checkpoint_every} must be >= 0")
        if strategy not in ("auto", "batched", "serial", "fused"):
            raise ValueError(
                f"strategy={strategy!r} must be 'auto', 'batched', 'serial' or 'fused'"
            )
        if iter_end is None:
            iter_end = num_epochs
        specs = self._specs()
        stats = (_make_pop_stats if strategy == "batched" else _make_pop_stats_fused)(specs)
        budget = self._chunk_budget(strategy)
        src = XPySom._as_source(data)
        if src is not None:
            if strategy == "serial":
                raise ValueError(
                    "strategy='serial' would re-read the dataset once per "
                    "member; streaming sources make a single pass that "
                    "serves every member — use strategy='auto' (or "
                    "'fused': serial's per-member fused kernels in one "
                    "pass) for source-like data"
                )
            d = getattr(src, "dim", self._input_len)
            if d != self._input_len:
                raise ValueError("Received %d features, expected %d." % (d, self._input_len))
            # out of core: the statistics folded over streamed superbatches
            # (the running total carried, so the chunks' partials add in the
            # resident order); one process only
            rows, n = self._superbatch_rows(), len(src)
            chunk = self._stream_chunk(rows, n, budget)

            def epoch_stats(w):
                return stats_streaming(specs[0], w, src, chunk, rows, stats_fn=stats)
        else:
            data2d = _as_numpy_2d(data)
            self._check_input_len(data2d)
            # one device-resident copy of the chunks for every member
            chunks, mask, n = self._members_list[0]._chunked(data2d, budget)

            def epoch_stats(w):
                return stats(w, chunks, mask)

        update = _pop_update(specs, num_epochs)
        w = self._stacked_device_weights()
        reporter = None
        if verbose:
            reporter = ProgressReporter(num_epochs * n)
            reporter.start()
        checkpoints = bool(checkpoint_every and checkpoint_path)
        for t in range(iter_beg, iter_end):
            w = update(w, epoch_stats(w), t)
            if reporter:
                reporter.update(t * n + n - 1)
            if checkpoints and ((t + 1 - iter_beg) % checkpoint_every == 0 or t + 1 == iter_end):
                self._write_back(w)
                self.save_checkpoint(checkpoint_path, epoch=t + 1)
        self._write_back(w)
        if verbose:
            sample = data2d if src is None else _first_superbatch(src)
            if sample is not None:
                print("\n quantization errors:", self.quantization_errors(sample))
        return self

    # -- checkpointing ---------------------------------------------------------

    def save_checkpoint(self, path, *, epoch=None):
        """Portable population checkpoint (stacked codebooks, every
        member's RNG state and config) in the JAX package's format; see
        ``utils.serialization``."""
        serialization.save_population_checkpoint(self, path, epoch=epoch)

    @classmethod
    def load_checkpoint(cls, path, *, device=None):
        """A population from a checkpoint of either package, on ``device``
        (default: the card)."""
        return serialization.load_population_checkpoint(path, device=device)

    # -- scoring ---------------------------------------------------------------

    def quantization_errors(self, data) -> np.ndarray:
        """Per-member quantization error, shape ``(P,)``. Source-like data
        streams in superbatches, each superbatch's per-member sums folded
        on the host after one synchronization at the end; no winner is
        kept."""
        qe_fn = make_population_qe_fn(self._members_list[0]._spec, self._n_members)
        w = self._stacked_device_weights()  # one upload per call
        src = XPySom._as_source(data)
        if src is not None:
            rows = self._superbatch_rows()
            chunk = self._stream_chunk(rows, len(src), self._n_parallel)
            parts = []
            for chunks, mask, _ in device_superbatches(src, rows, chunk, self._device):
                self._check_input_len(chunks)
                parts.append(qe_fn(w, chunks, mask))
            tot = np.zeros((self._n_members,), np.float64)
            n = 0.0
            for t, c in parts:
                tot += t.cpu().numpy()
                n += float(c)
        else:
            data2d = np.atleast_2d(_as_numpy_2d(data))
            self._check_input_len(data2d)
            chunks, mask, _ = self._members_list[0]._chunked(data2d, self._n_parallel)
            tot, n = qe_fn(w, chunks, mask)
            tot, n = tot.cpu().numpy(), float(n)
        if n == 0:
            warn("quantization_errors over an empty data set: returning NaN")
            return np.full((self._n_members,), np.nan, dtype=np.float64)
        return tot / n

    def _check_input_len(self, data2d) -> None:
        if data2d.shape[-1] != self._input_len:
            raise ValueError(
                "Received %d features, expected %d." % (data2d.shape[-1], self._input_len)
            )

    def best(self, data) -> XPySom:
        """The member with the lowest quantization error on ``data`` — a
        normal ``XPySom`` carrying its population-trained codebook."""
        qes = self.quantization_errors(data)
        if np.isnan(qes).all():
            # model selection over nothing is an error, not a warning
            raise ValueError("best() over an empty data set")
        return self._members_list[int(np.argmin(qes))]

    def __repr__(self):
        return (
            f"SomPopulation(n_members={self._n_members}, x={self._x}, "
            f"y={self._y}, input_len={self._input_len})"
        )

    # -- serialization ---------------------------------------------------------

    def __getstate__(self):
        """Pickle support: drop the resolved device, keep the one the
        caller gave (members do the same)."""
        state = self.__dict__.copy()
        state["_resolved_device"] = None
        return state

