"""Plain PyTorch batch SOM under the cosine activation: the reference of
configurations that search by cosine distance.

It is ``reference/som.py`` with the search changed. That file's
configuration refuses every activation but euclidean and manhattan, so
this one brings its own (:class:`SomConfig`, which also takes
``cosine``) and its own search (:func:`winners`); the decays, the
statistics, the update, QE, TE and the winner gaps are ``som.py``'s,
loaded from beside this file. QE and TE stay euclidean whatever the
activation, as in ``som.py``. It imports torch, numpy and math only:
nothing of the program. TF32 stays off, as in ``som.py``.

The search. Upstream's cosine distance of a sample ``x`` to a unit ``w``
is ``1 - x.w / (||x|| ||w||)``, and a sample's best-matching unit the
first index of its least. Here each sample's unit is the first index of
the greatest ``x.w_hat`` in float64, ``w_hat`` the unit's code vector
over its norm. Where this departs from the formula:

- ``||x||`` is left out: it is one positive number a row, which scales
  every similarity of the row alike and moves no argmax (a row of zeros,
  whose distances upstream are all NaN, takes unit 0, the first index of
  a row of zeros);
- a unit whose code vector is zero stays zero in ``w_hat`` (upstream
  divides by zero there): its similarity is 0 to every sample;
- "first index on a tie" is ``torch.argmax``'s rule, which returns the
  first of equal greatest values; the float64 products break fewer ties
  than upstream's float32 distances.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from dataclasses import dataclass

import torch

__all__ = ["SomConfig", "decay", "winners", "step", "train", "epoch_stats", "update",
           "quantization_error", "topographic_error", "winner_gaps", "unit_directions"]


def _load_som():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "som.py")
    spec = importlib.util.spec_from_file_location("portbench_reference_som", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks its module up
    spec.loader.exec_module(module)
    return module


_som = _load_som()
_F64 = torch.float64

decay = _som.decay
epoch_stats = _som.epoch_stats
update = _som.update
quantization_error = _som.quantization_error
topographic_error = _som.topographic_error


@dataclass(frozen=True)
class SomConfig(_som.SomConfig):
    """``som.SomConfig`` that also serves the cosine activation."""

    def __post_init__(self):
        if (self.decay, self.neighborhood, self.topology) != (
                "exponential", "gaussian", "rectangular"):
            raise ValueError("the reference serves the exponential decay, the gaussian "
                             "neighbourhood and the rectangular topology")
        if self.activation not in ("euclidean", "manhattan", "cosine"):
            raise ValueError(f"the reference serves euclidean, manhattan and cosine, "
                             f"not {self.activation!r}")


def unit_directions(w):
    """Each code vector over its norm, float64; a zero code vector stays
    zero."""
    w = w.to(_F64)
    norm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
    return torch.where(norm > 0, w / torch.where(norm > 0, norm, torch.ones_like(norm)),
                       torch.zeros_like(w))


def _similarities(x, w_hat, dtype):
    """``x . w_hat`` of every row and unit, in ``dtype``."""
    return x.to(dtype) @ w_hat.to(dtype).T


def winners(X, w, activation="euclidean", dtype=None):
    """Each row's best-matching unit (int64, first index on a tie): the
    greatest ``x . w_hat`` in ``dtype`` (float64 by default) under
    ``cosine``, ``som.winners`` under the other activations."""
    if activation != "cosine":
        return _som.winners(X, w, activation, dtype)
    w_hat = unit_directions(w.reshape(-1, X.shape[1]))
    out = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    with _som._no_tf32():
        for s, e in _som._blocks(X.shape[0], _som._rows_per_block("euclidean", w_hat.shape[0],
                                                                 X.shape[1])):
            out[s:e] = torch.argmax(_similarities(X[s:e], w_hat, dtype or _F64), dim=1)
    return out


def step(cfg: SomConfig, X, w, t: int, epochs: int, search_dtype=None):
    """Epoch ``t`` of an ``epochs``-epoch schedule from the codebook
    ``w``, as ``som.step`` with this file's :func:`winners`."""
    w = w.reshape(cfg.x, cfg.y, cfg.input_len).to(_F64)
    bmu = winners(X, w, cfg.activation, search_dtype)
    s, cnt = epoch_stats(X, bmu, cfg.x * cfg.y)
    return update(cfg, w, s, cnt, t, epochs)


def train(cfg: SomConfig, X, w0, epochs: int, search_dtype=None):
    """``epochs`` epochs from ``w0``: :func:`step` after :func:`step`."""
    w = w0
    for t in range(epochs):
        w = step(cfg, X, w, t, epochs, search_dtype)
    return w


def winner_gaps(X, w, got, activation="euclidean"):
    """For each row, how much farther the unit ``got`` lies than the
    nearest unit, in float64 under the activation distance: under
    ``cosine`` the greatest ``x . w_hat`` less ``got``'s, over ``||x||``
    (a gap of cosine distance; 0 where ``got`` is a nearest unit), else
    ``som.winner_gaps``."""
    if activation != "cosine":
        return _som.winner_gaps(X, w, got, activation)
    w_hat = unit_directions(w.reshape(-1, X.shape[1]))
    got = got.to(torch.int64)
    out = torch.empty(X.shape[0], dtype=_F64, device=X.device)
    with _som._no_tf32():
        for s, e in _som._blocks(X.shape[0], _som._rows_per_block("euclidean", w_hat.shape[0],
                                                                 X.shape[1])):
            x = X[s:e].to(_F64)
            sim = _similarities(x, w_hat, _F64)
            mine = sim.gather(1, got[s:e, None])[:, 0]
            norm = torch.linalg.vector_norm(x, dim=1)
            out[s:e] = (sim.max(1).values - mine) / torch.where(norm > 0, norm, torch.ones_like(norm))
    return out
