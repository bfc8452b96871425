"""Pairwise sample-to-codebook distances (plain PyTorch).

Counterpart of ``xpysom_dask_tpu/ops/distances.py``: the same registry of
names, the same semantics, on torch tensors. Every function takes ``x``
(N, D) and a flattened codebook ``w`` (XY, D) and returns the (N, XY)
distance matrix. These are the plain-matrix path of the BMU search (the
``_no_opt`` names and ``p <= 0``, see ``core._kernel_bmu_kind``); the
served activations search through the kernels of ``ops/kernels``.

Every matmul here runs in full fp32: the JAX package pins
``Precision.HIGHEST`` because the BMU argmin is sensitive to reduced
precision. On the GPU a float32 matmul may go through TF32 when the
caller's process has switched it on, so each matmul runs under
:func:`fp32_matmul`, which turns TF32 off and restores the caller's
setting afterwards. The broadcast forms never build an (N, XY, D) tensor:
they loop over d and add into one (N, XY) accumulator, in index order.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = [
    "fp32_matmul",
    "euclidean_squared_distance_part",
    "euclidean_squared_distance",
    "euclidean_distance",
    "cosine_distance",
    "norm_p_power_distance_generic",
    "norm_p_power_distance_even",
    "norm_p_power_distance",
    "manhattan_distance",
    "manhattan_distance_no_opt",
    "sum_over_d",
    "DistanceFunction",
    "DISTANCE_NAMES",
]

_F32 = torch.float32


@contextlib.contextmanager
def fp32_matmul():
    """Run float32 matmuls in full fp32 (no TF32) inside the block and
    restore the caller's settings on exit."""
    prev_mm = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_mm
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def _w_sq(w):
    return torch.sum(w * w, dim=1, keepdim=True)


def _dot(x, w):
    with fp32_matmul():
        return x.float() @ w.float().T


def euclidean_squared_distance_part(x, w, w_sq=None):
    """Partial squared L2: ``-2 x@Wᵀ + ‖w‖²`` (argmin-equivalent to the
    full squared distance)."""
    if w_sq is None:
        w_sq = _w_sq(w)
    return -2.0 * _dot(x, w) + w_sq.reshape(1, -1)


def euclidean_squared_distance(x, w, w_sq=None):
    """Full squared L2 distance."""
    return euclidean_squared_distance_part(x, w, w_sq) + _w_sq(x)


def euclidean_distance(x, w, w_sq=None):
    """L2 distance; fp-cancellation residues below zero clamp to 0 before
    the sqrt."""
    return torch.sqrt(torch.clamp(euclidean_squared_distance(x, w, w_sq), min=0.0))


def cosine_distance(x, w, w_sq=None):
    """Cosine distance ``1 - x·w / (‖x‖‖w‖)``, ``nan_to_num`` on the
    similarity (a zero row gives similarity 0, distance 1)."""
    if w_sq is None:
        w_sq = _w_sq(w)
    denum = torch.sqrt(_w_sq(x) * w_sq.reshape(1, -1))
    return 1.0 - torch.nan_to_num(_dot(x, w) / denum)


def sum_over_d(x, w, term):
    """``Σ_d term(|x_d − w_d|)`` as (N, XY), added in index order of d."""
    x, w = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=_F32, device=x.device)
    t = torch.empty_like(acc)
    for k in range(x.shape[1]):
        torch.sub(x[:, k : k + 1], w[None, :, k], out=t)
        acc.add_(term(t.abs_()))
    return acc


def norm_p_power_distance_generic(x, w, p=2):
    """``Σ_d |x_d − w_d|**p`` by broadcast, one d at a time."""
    return sum_over_d(x, w, lambda t: torch.pow(t, p))


def norm_p_power_distance_even(x, w, p=2):
    """Binomial-expansion GEMM form of ``Σ_d (x_d − w_d)**p`` for even
    ``p >= 2``: ``Σ_e (−1)^e C(p,e) (x^(p−e))·(w^e)ᵀ``. An integer-valued
    float p is accepted (the ``p % 2 == 0`` test selects it)."""
    if p % 2 != 0:
        raise ValueError("p must be even")
    if p < 2:
        raise ValueError("p must be even and >= 2")
    p = int(p)
    x, w = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[0]), dtype=_F32, device=x.device)
    k = 1
    for e in range(p + 1):
        sign = -1.0 if e % 2 == 1 else 1.0
        acc = acc + sign * k * _dot(x ** (p - e), w**e)
        k = (k * (p - e)) // (e + 1)
    return acc


def norm_p_power_distance(x, w, p=2):
    """Norm-p distance raised to the p-th power: the GEMM form for even
    ``p >= 2``, the broadcast form otherwise (zero and negative p
    included: the expansion does not exist for them)."""
    if p % 2 == 0 and p >= 2:
        return norm_p_power_distance_even(x, w, p)
    return norm_p_power_distance_generic(x, w, p)


def manhattan_distance_no_opt(x, w):
    """Broadcast-form Manhattan distance, one d at a time."""
    return sum_over_d(x, w, lambda t: t)


def manhattan_distance(x, w):
    """Manhattan distance matrix: K8 (``ops/kernels/manhattan.py``) on a
    CUDA tensor, its plain version (the broadcast form) on a CPU tensor."""
    from .kernels.manhattan import manhattan_distance as k8

    return k8(x.float().contiguous(), w.float().contiguous())


_DISTANCE_FUNCTIONS = {
    "euclidean": euclidean_squared_distance_part,
    "euclidean_no_opt": euclidean_squared_distance,
    "manhattan": manhattan_distance,
    "manhattan_no_opt": manhattan_distance_no_opt,
    "cosine": cosine_distance,
    "norm_p": norm_p_power_distance,
    "norm_p_no_opt": norm_p_power_distance_generic,
}

DISTANCE_NAMES = tuple(_DISTANCE_FUNCTIONS)

# Distances that accept a precomputed ‖w‖² (a cache worth keeping).
_CACHEABLE = frozenset({"euclidean", "cosine"})
# Distances whose signature accepts w_sq at all.
_TAKES_WSQ = frozenset({"euclidean", "euclidean_no_opt", "cosine"})


class DistanceFunction:
    """Name → distance dispatcher. ``__call__`` takes the codebook in its
    (X, Y, D) shape; an optional cached ``w_flat_sq`` (XY, 1) is forwarded
    to the distances that take it."""

    def __init__(self, name, kwargs=None):
        if name not in _DISTANCE_FUNCTIONS:
            raise ValueError(
                "%s not supported. Distances available: %s"
                % (name, ", ".join(DISTANCE_NAMES))
            )
        self.name = name
        self.kwargs = dict(kwargs or {})
        self.can_cache = name in _CACHEABLE
        self._fn = _DISTANCE_FUNCTIONS[name]

    def flat(self, x, w_flat, w_flat_sq=None):
        """Apply to an already-flattened ``(XY, D)`` codebook."""
        if w_flat_sq is not None and self.name in _TAKES_WSQ:
            return self._fn(x, w_flat, w_flat_sq, **self.kwargs)
        return self._fn(x, w_flat, **self.kwargs)

    def __call__(self, x, w, w_flat_sq=None):
        return self.flat(x, w.reshape(-1, w.shape[-1]), w_flat_sq)
