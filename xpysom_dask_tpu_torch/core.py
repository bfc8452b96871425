"""Functional training/inference core of the batch SOM, in PyTorch.

Counterpart of ``xpysom_dask_tpu/core.py``, euclidean route only. The
algorithm is the same: per chunk, the BMU search (K1) and a scatter of
``[x | 1]`` rows into per-BMU sums ``S`` and counts ``cnt`` (K9); per
epoch, the separable neighborhood operator and the merge
``W' = where(den ≠ 0, num / den, W)``. Where the JAX core runs
``lax.fori_loop``/``lax.scan`` under ``jit``, this core runs Python loops
over epochs and chunks of eager launches.

``SomSpec.use_kernels`` selects the CUDA kernels (True, the default) or
their plain PyTorch versions (False) for tensors on the card; on CPU
tensors the kernel wrappers always run the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .ops.decays import DECAY_REGISTRY
from .ops.distances import DistanceFunction
from .ops.kernels import bmu as kbmu
from .ops.kernels import stats as kstats
from .ops.neighborhoods import apply_operator, neighborhood_operator

_F32 = torch.float32

__all__ = [
    "SomSpec",
    "grid_coordinates",
    "chunk_data",
    "make_epoch_step",
    "make_train_fn",
    "make_bmu_fn",
    "make_quantization_stats_fn",
    "make_topographic_stats_fn",
]

_MODES = ("packed", "bf16", "split2", "split3", "highest", "margin")


@dataclass(frozen=True)
class SomSpec:
    """Static SOM configuration (the reference constructor surface); the
    codebook lives outside. ``bmu_precision`` is validated against the
    JAX package's modes, of which the port serves ``'packed'``."""

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
    bmu_precision: Optional[str] = None  # None = 'packed'
    use_kernels: Optional[bool] = None  # None = True

    def __post_init__(self):
        mode = "packed" if self.bmu_precision is None else str(self.bmu_precision).lower()
        if mode not in _MODES:
            raise ValueError(
                f"bmu_precision={self.bmu_precision!r} not recognized "
                "(packed|bf16|split2|split3|highest|margin)"
            )
        if mode != "packed":
            raise NotImplementedError(
                f"bmu_precision={mode!r} is not ported yet (ROADMAP Queue 1 "
                "item 6); the port serves 'packed'"
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


def _bmu_chunk(spec: SomSpec, cb: kbmu.PackedCodebook, x):
    """Flat BMU indices (int32) for one chunk: the euclidean search,
    centered by the codebook mean (``PackedCodebook``)."""
    fn = kbmu.bmu_argmin if spec.use_kernels else kbmu.bmu_argmin_plain
    idx, _ = fn(*cb.operands(x))
    return idx


def _accumulate_stats(spec: SomSpec, w_flat, data, mask):
    """Per-BMU sufficient statistics ``(S, cnt)`` over all chunks.

    Each chunk scatters into a *fresh* partial that is then added to the
    running total: scattering +1.0 rows straight into a large f32 total
    drops increments once a node's count passes 2^24."""
    d_dim = data.shape[-1]
    cb = kbmu.PackedCodebook(w_flat)
    scatter = kstats.scatter_stats if spec.use_kernels else kstats.scatter_stats_plain
    acc = torch.zeros((spec.xy, d_dim + 1), dtype=_F32, device=w_flat.device)
    for c in range(data.shape[0]):
        x, m = data[c], mask[c]
        bmu = _bmu_chunk(spec, cb, x)
        acc = acc + scatter(x, m, bmu, spec.xy)
    return acc[:, :d_dim], acc[:, d_dim]


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
    t = torch.tensor(t, dtype=torch.int32, device=device)
    eta = decay(spec.learning_rate, spec.learning_rateN, t, num_epochs)
    sig = decay(spec.sigma, spec.sigmaN, t, num_epochs)
    return eta, sig


def make_epoch_step(spec: SomSpec, num_epochs: int):
    """``step(w, data, mask, t) -> w'`` for one epoch; ``w`` is the
    (X, Y, D) f32 codebook, ``data``/``mask`` the (C, chunk, D)/(C, chunk)
    chunks, ``t`` the epoch index of a ``num_epochs`` schedule."""
    spec.distance_fn()  # raises for activations the port does not serve

    def step(w, data, mask, t):
        w_flat = w.reshape(spec.xy, spec.input_len)
        eta, sig = _decays(spec, t, num_epochs, w.device)
        s, cnt = _accumulate_stats(spec, w_flat, data, mask)
        return _update_from_stats(spec, w_flat, s, cnt, eta, sig).reshape(w.shape)

    return step


def make_train_fn(spec: SomSpec, num_epochs: int):
    """``train(w, data, mask, iter_beg, iter_end) -> w'``: epochs
    ``[iter_beg, iter_end)`` of a ``num_epochs`` schedule, the decays
    computed from each epoch index."""
    step = make_epoch_step(spec, num_epochs)

    def run(w, data, mask, iter_beg, iter_end):
        for t in range(int(iter_beg), int(iter_end)):
            w = step(w, data, mask, t)
        return w

    return run


def make_bmu_fn(spec: SomSpec):
    """``bmu(w, data) -> (C, chunk) int32`` flat grid indices."""
    spec.distance_fn()

    def run(w, data):
        cb = kbmu.PackedCodebook(w.reshape(spec.xy, spec.input_len))
        return torch.stack([_bmu_chunk(spec, cb, data[c]) for c in range(data.shape[0])])

    return run


def make_quantization_stats_fn(spec: SomSpec):
    """``qstats(w, data, mask) -> (Σ‖x - W[bmu]‖, Σ mask)``, BMU by
    euclidean distance."""

    def run(w, data, mask):
        w_flat = w.reshape(spec.xy, spec.input_len)
        cb = kbmu.PackedCodebook(w_flat)
        tot = torch.zeros((), dtype=_F32, device=w.device)
        n = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            bmu = _bmu_chunk(spec, cb, x)
            err = torch.linalg.vector_norm(x - w_flat[bmu.long()], dim=1)
            tot = tot + torch.sum(err * m)
            n = n + torch.sum(m)
        return tot, n

    return run


def make_topographic_stats_fn(spec: SomSpec):
    """``tstats(w, data, mask) -> (Σ errors, Σ mask)``: top-2 BMUs by
    euclidean distance (K2), an error where they are not adjacent on the
    rectangular grid (``|Δx| > 1 or |Δy| > 1``)."""
    if spec.topology == "hexagonal" and spec.x != spec.y:
        raise ValueError(
            "topographic_error on hexagonal topology requires a square map "
            f"(got {spec.x}x{spec.y})"
        )
    if spec.topology != "rectangular":
        raise NotImplementedError(
            "hexagonal topographic_error is not ported yet (ROADMAP Queue 1 "
            "item 6)"
        )
    top2 = kbmu.bmu_top2 if spec.use_kernels else kbmu.bmu_top2_plain

    def run(w, data, mask):
        cb = kbmu.PackedCodebook(w.reshape(spec.xy, spec.input_len))
        errs = torch.zeros((), dtype=_F32, device=w.device)
        n = torch.zeros((), dtype=_F32, device=w.device)
        for c in range(data.shape[0]):
            x, m = data[c], mask[c]
            i1, _, i2, _ = top2(*cb.operands(x))
            bad = (torch.abs(i1 // spec.y - i2 // spec.y) > 1) | (
                torch.abs(i1 % spec.y - i2 % spec.y) > 1
            )
            errs = errs + torch.sum(bad.to(_F32) * m)
            n = n + torch.sum(m)
        return errs, n

    return run
