"""Plain PyTorch batch SOM whose update is two explicit GEMMs: the
reference of configurations whose map is too large for a contraction
planner to be trusted with.

It is ``reference/som.py`` with one function changed. That file's update
contracts the gaussian operator with a three-operand ``einsum``, which
stays tractable only where torch finds the two-GEMM order; left to the
order written, a 1044 x 960 map would form the ``X·X·Y·Y`` outer product
first (about 8 TB in float64). Here the contraction is written out: over
the map's first axis, then over its second, in float64, a block of
columns at a time, so that it fits beside the data. Everything else (the
configuration, decays, search, statistics, QE, TE, winner gaps) is
``som.py``'s, loaded from beside this file. It imports torch, numpy and
math only: nothing of the program. TF32 stays off, as in ``som.py``.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import torch

__all__ = ["SomConfig", "decay", "winners", "step", "train", "epoch_stats", "update",
           "quantization_error", "topographic_error", "winner_gaps"]


def _load_som():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "som.py")
    spec = importlib.util.spec_from_file_location("portbench_reference_som", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks its module up
    spec.loader.exec_module(module)
    return module


_som = _load_som()
_F64 = torch.float64
COLUMNS = 64  # columns of the statistics contracted at a time

SomConfig = _som.SomConfig
decay = _som.decay
winners = _som.winners
epoch_stats = _som.epoch_stats
quantization_error = _som.quantization_error
topographic_error = _som.topographic_error
winner_gaps = _som.winner_gaps


def _separable(ax, ay, s3):
    """``out[i, j, c] = sum_a sum_b ax[a, i] ay[b, j] s3[a, b, c]`` as two
    GEMMs, float64: over ``a``, an (X, X) by (X, Y·C) product, then over
    ``b``, a (Y, Y) by (Y, X·C) product."""
    x, y, c = s3.shape
    over_a = (ax.T @ s3.reshape(x, y * c)).reshape(x, y, c)
    by_b = over_a.transpose(0, 1).reshape(y, x * c)
    return (ay.T @ by_b).reshape(y, x, c).transpose(0, 1)


def update(cfg: SomConfig, w, s, cnt, t: int, T: int):
    """``som.update``'s batch update of epoch ``t`` from the statistics,
    float64, with ``H = Ax kron Ay`` applied by :func:`_separable`."""
    eta = decay(cfg.learning_rate, cfg.learning_rateN, t, T)
    sig = decay(cfg.sigma, cfg.sigmaN, t, T)
    d = 2.0 * cfg.std_coeff ** 2 * sig ** 2

    def factor(n):
        i = torch.arange(n, dtype=_F64, device=w.device)
        return torch.exp(-((i[None, :] - i[:, None]) ** 2) / d)  # [centre, node]

    ax, ay = factor(cfg.x), factor(cfg.y)
    s3 = s.reshape(cfg.x, cfg.y, -1)
    num = torch.empty((cfg.x, cfg.y, s3.shape[2]), dtype=_F64, device=w.device)
    with _som._no_tf32():
        for a in range(0, s3.shape[2], COLUMNS):
            num[:, :, a:a + COLUMNS] = _separable(ax, ay, s3[:, :, a:a + COLUMNS].contiguous())
        den = _separable(ax, ay, cnt.reshape(cfg.x, cfg.y, 1))
    num = num.reshape(cfg.x * cfg.y, -1) * eta
    den = den.reshape(-1, 1) * eta
    w64 = w.reshape(cfg.x * cfg.y, -1).to(_F64)
    return torch.where(den != 0, num / den, w64).reshape(cfg.x, cfg.y, -1)


def step(cfg: SomConfig, X, w, t: int, epochs: int, search_dtype=None):
    """Epoch ``t`` of an ``epochs``-epoch schedule from the codebook
    ``w``, as ``som.step`` with this file's :func:`update`."""
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
