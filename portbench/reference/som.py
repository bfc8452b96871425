"""Plain PyTorch batch SOM: the benchmark's reference.

It follows the batch algorithm of upstream xpysom (and of the JAX golden
model, ``GoldenSom``), written from the formulas, not from the code under
test. It imports torch, numpy and math only: nothing of the program.

Per epoch ``t`` of a ``T``-epoch schedule:

- ``eta = lr0 * exp(-t * ln(lr0 / lrN) / T)``, ``sigma`` likewise
  (exponential decay; ``-ln(0.1) / T`` where the end value is 0);
- each sample's best-matching unit under the activation distance, the
  first index on a tie;
- ``H[b, j] = exp(-(bx - jx)^2 / d) * exp(-(by - jy)^2 / d)`` with
  ``d = 2 * std_coeff^2 * sigma^2`` (the gaussian on a rectangular grid);
- ``num[j] = eta * sum_n H[bmu_n, j] x_n``, ``den[j] = eta * sum_n
  H[bmu_n, j]`` and ``W' = where(den != 0, num / den, W)``.

The quantization error is the mean euclidean distance of each sample to
its euclidean best-matching unit, whatever the activation; the
topographic error is the share of samples whose two nearest units (by
euclidean distance) are not neighbours, ``|dx| > 1 or |dy| > 1``.

Precision: the statistics and the update accumulate in float64. The
euclidean search runs in ``search_dtype`` (float64 by default, the exact
answer against which the program's float32 search is judged); the
manhattan search runs in float32 unless told otherwise. A lower
``search_dtype`` (``torch.bfloat16``) turns the reference into the
benchmark's lower-precision control. Every float32 matmul runs with TF32
off. Work goes in blocks of rows so that it fits beside the data.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

__all__ = ["SomConfig", "decay", "winners", "step", "train", "epoch_stats", "update",
           "quantization_error", "topographic_error", "winner_gaps"]

_F64 = torch.float64


@dataclass(frozen=True)
class SomConfig:
    """What the reference needs of a configuration (``configs/*.json``)."""

    x: int
    y: int
    input_len: int
    sigma: float
    sigmaN: float
    learning_rate: float
    learning_rateN: float
    activation: str = "euclidean"
    std_coeff: float = 0.5
    decay: str = "exponential"
    neighborhood: str = "gaussian"
    topology: str = "rectangular"

    def __post_init__(self):
        if (self.decay, self.neighborhood, self.topology) != (
                "exponential", "gaussian", "rectangular"):
            raise ValueError("the reference serves the exponential decay, the gaussian "
                             "neighbourhood and the rectangular topology")
        if self.activation not in ("euclidean", "manhattan"):
            raise ValueError(f"the reference serves euclidean and manhattan, not {self.activation!r}")

    @classmethod
    def from_som_kwargs(cls, kw: dict) -> "SomConfig":
        """From an ``XPySom`` constructor's keyword arguments (the
        ``som`` group of a configuration file)."""
        return cls(
            x=kw["x"], y=kw["y"], input_len=kw["input_len"], sigma=float(kw["sigma"]),
            sigmaN=float(kw["sigmaN"]), learning_rate=float(kw["learning_rate"]),
            learning_rateN=float(kw["learning_rateN"]),
            activation=kw.get("activation_distance", "euclidean"),
            std_coeff=float(kw.get("std_coeff", 0.5)),
            decay=kw.get("decay_function", "exponential"),
            neighborhood=kw.get("neighborhood_function", "gaussian"),
            topology=kw.get("topology", "rectangular"),
        )


@contextlib.contextmanager
def _no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def decay(val0: float, valN: float, t: int, T: int) -> float:
    """The exponential schedule, in float64."""
    diff = -math.log(0.1) / T if valN == 0 else -math.log(valN / val0) / T
    return val0 * math.exp(-t * diff)


def _blocks(n: int, rows: int):
    for s in range(0, n, rows):
        yield s, min(n, s + rows)


def _euclidean_scores(x, w, w_sq, dtype):
    """``||w||^2 - 2 x.w`` (the squared distance less ``||x||^2``) in
    ``dtype``."""
    return torch.addmm(w_sq.to(dtype)[None, :], x.to(dtype), w.to(dtype).T, alpha=-2)


def _manhattan_scores(x, w, dtype, node_block=2048):
    """``sum_d |x_d - w_d|`` in ``dtype``, a block of nodes at a time."""
    xd, wd = x.to(dtype), w.to(dtype)
    out = torch.empty((x.shape[0], w.shape[0]), dtype=dtype, device=x.device)
    for s, e in _blocks(w.shape[0], node_block):
        out[:, s:e] = (xd[:, None, :] - wd[None, s:e, :]).abs_().sum(-1)
    return out


def _scores(x, w, activation, dtype, w_sq=None):
    if activation == "euclidean":
        return _euclidean_scores(x, w, w_sq, dtype)
    return _manhattan_scores(x, w, dtype)


def _rows_per_block(activation: str, xy: int, d: int) -> int:
    """Rows a block: the euclidean score matrix is about 2 GiB in
    float64; the manhattan block's (rows, 2048, D) temporary about 1 GiB
    in float32."""
    if activation == "euclidean":
        return max(1, (1 << 28) // xy)
    return max(1, (1 << 28) // (2048 * d))


def winners(X, w, activation="euclidean", dtype=None):
    """Each row's best-matching unit (int64, first index on a tie)."""
    dtype = dtype or (_F64 if activation == "euclidean" else torch.float32)
    w = w.reshape(-1, X.shape[1])
    w_sq = (w.to(_F64) ** 2).sum(1) if activation == "euclidean" else None
    out = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    with _no_tf32():
        for s, e in _blocks(X.shape[0], _rows_per_block(activation, w.shape[0], X.shape[1])):
            out[s:e] = torch.argmin(_scores(X[s:e], w, activation, dtype, w_sq), dim=1)
    return out


def epoch_stats(X, bmu, xy: int):
    """Per-unit sums of the samples and counts, float64: ``(S, cnt)``."""
    s = torch.zeros((xy, X.shape[1]), dtype=_F64, device=X.device)
    cnt = torch.zeros(xy, dtype=_F64, device=X.device)
    for a, b in _blocks(X.shape[0], 1 << 20):
        s.index_add_(0, bmu[a:b], X[a:b].to(_F64))
        cnt.index_add_(0, bmu[a:b], torch.ones(b - a, dtype=_F64, device=X.device))
    return s, cnt


def update(cfg: SomConfig, w, s, cnt, t: int, T: int):
    """The batch update of epoch ``t`` from the statistics, float64. The
    gaussian is separable on the rectangular grid: ``H = Ax kron Ay``."""
    eta = decay(cfg.learning_rate, cfg.learning_rateN, t, T)
    sig = decay(cfg.sigma, cfg.sigmaN, t, T)
    d = 2.0 * cfg.std_coeff ** 2 * sig ** 2

    def factor(n):
        i = torch.arange(n, dtype=_F64, device=w.device)
        return torch.exp(-((i[None, :] - i[:, None]) ** 2) / d)  # [centre, node]

    ax, ay = factor(cfg.x), factor(cfg.y)
    s3 = s.reshape(cfg.x, cfg.y, -1)
    c2 = cnt.reshape(cfg.x, cfg.y)
    num = torch.einsum("ai,bj,abd->ijd", ax, ay, s3).reshape(cfg.x * cfg.y, -1) * eta
    den = (torch.einsum("ai,bj,ab->ij", ax, ay, c2).reshape(-1) * eta)[:, None]
    w64 = w.reshape(cfg.x * cfg.y, -1).to(_F64)
    return torch.where(den != 0, num / den, w64).reshape(cfg.x, cfg.y, -1)


def step(cfg: SomConfig, X, w, t: int, epochs: int, search_dtype=None):
    """Epoch ``t`` of an ``epochs``-epoch schedule from the codebook
    ``w``, in float64 (the search in ``search_dtype``). Returns the
    (X, Y, D) float64 codebook."""
    w = w.reshape(cfg.x, cfg.y, cfg.input_len).to(_F64)
    bmu = winners(X, w, cfg.activation, search_dtype)
    s, cnt = epoch_stats(X, bmu, cfg.x * cfg.y)
    return update(cfg, w, s, cnt, t, epochs)


def train(cfg: SomConfig, X, w0, epochs: int, search_dtype=None):
    """``epochs`` epochs of the batch SOM from ``w0``: :func:`step` after
    :func:`step`."""
    w = w0
    for t in range(epochs):
        w = step(cfg, X, w, t, epochs, search_dtype)
    return w


def quantization_error(X, w, search_dtype=_F64) -> float:
    """Mean euclidean distance of each row to its euclidean BMU."""
    w = w.reshape(-1, X.shape[1])
    bmu = winners(X, w, "euclidean", search_dtype)
    tot = 0.0
    w64 = w.to(_F64)
    for a, b in _blocks(X.shape[0], 1 << 20):
        tot += float(torch.linalg.vector_norm(X[a:b].to(_F64) - w64[bmu[a:b]], dim=1).sum())
    return tot / X.shape[0]


def topographic_error(X, w, y: int, search_dtype=_F64) -> float:
    """Share of rows whose two euclidean-nearest units are not
    neighbours on the rectangular grid (``y`` columns)."""
    w = w.reshape(-1, X.shape[1])
    w_sq = (w.to(_F64) ** 2).sum(1)
    bad = 0
    with _no_tf32():
        for s, e in _blocks(X.shape[0], _rows_per_block("euclidean", w.shape[0], X.shape[1])):
            top = torch.topk(_euclidean_scores(X[s:e], w, w_sq, search_dtype), 2, dim=1,
                             largest=False).indices
            b1, b2 = top[:, 0], top[:, 1]
            far = ((b1 // y - b2 // y).abs() > 1) | ((b1 % y - b2 % y).abs() > 1)
            bad += int(far.sum())
    return bad / X.shape[0]


def winner_gaps(X, w, got, activation="euclidean"):
    """For each row, how much farther the unit ``got`` lies than the
    nearest unit, in float64 under the activation distance (squared
    euclidean or manhattan): 0 where ``got`` is a nearest unit."""
    w = w.reshape(-1, X.shape[1]).to(_F64)
    got = got.to(torch.int64)
    out = torch.empty(X.shape[0], dtype=_F64, device=X.device)
    for s, e in _blocks(X.shape[0], _rows_per_block(activation, w.shape[0], X.shape[1])):
        x = X[s:e].to(_F64)
        if activation == "euclidean":
            d = ((x * x).sum(1)[:, None] + (w * w).sum(1)[None, :]) - 2 * (x @ w.T)
            mine = ((x - w[got[s:e]]) ** 2).sum(1)
        else:
            d = _manhattan_scores(x, w, _F64)
            mine = (x - w[got[s:e]]).abs().sum(1)
        out[s:e] = mine - d.min(1).values
    return out
