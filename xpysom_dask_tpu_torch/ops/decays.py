"""Decay schedules for learning rate and neighborhood radius.

Counterpart of ``xpysom_dask_tpu/ops/decays.py``. The JAX package
evaluates these from a traced int32 epoch index, so every schedule is
computed in float32; here the index is an int32 tensor and torch promotes
it the same way. Kept quirks: ``exponential`` substitutes
``k = -ln(0.1) / T`` when ``valN == 0``; ``linear`` returns ``val0`` when
``T == 1``; ``asymptotic`` ignores ``valN``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "asymptotic_decay",
    "exponential_decay",
    "linear_decay",
    "DECAY_REGISTRY",
    "make_decay",
]


def _t(curr_iter) -> torch.Tensor:
    if isinstance(curr_iter, torch.Tensor):
        return curr_iter
    return torch.tensor(curr_iter, dtype=torch.int32)


def asymptotic_decay(val0, valN, curr_iter, max_iter):
    """``val0 / (1 + 2 t / T)``. ``valN`` is ignored (asymptotic)."""
    del valN
    return val0 / (1.0 + 2.0 * _t(curr_iter) / max_iter)


def exponential_decay(val0, valN, curr_iter, max_iter):
    """``val0 * exp(-t * k)`` with ``k = -ln(valN/val0)/T`` (or
    ``-ln(0.1)/T`` when ``valN == 0``)."""
    if valN == 0:
        diff = -math.log(0.1) / max_iter
    else:
        diff = -math.log(valN / val0) / max_iter
    return val0 * torch.exp(-_t(curr_iter) * diff)


def linear_decay(val0, valN, curr_iter, max_iter):
    """Linear interpolation from ``val0`` (t=0) to ``valN`` (t=T-1)."""
    t = _t(curr_iter)
    if max_iter != 1:
        return val0 + (valN - val0) * t / (max_iter - 1)
    return val0 * torch.ones_like(t, dtype=torch.float32)


DECAY_REGISTRY = {
    "exponential": exponential_decay,
    "asymptotic": asymptotic_decay,
    "linear": linear_decay,
}


def make_decay(name: str):
    """Resolve a decay schedule by name, raising ValueError on an unknown
    one."""
    if name not in DECAY_REGISTRY:
        raise ValueError(
            "%s not supported. Functions available: %s"
            % (name, ", ".join(DECAY_REGISTRY.keys()))
        )
    return DECAY_REGISTRY[name]
