"""Pairwise sample-to-codebook distances (plain PyTorch).

Counterpart of ``xpysom_dask_tpu/ops/distances.py``. Only the euclidean
activation is served by this slice of the port; the other names raise
``NotImplementedError`` until ROADMAP Queue 1 item 6 ports them.

Every matmul here runs in full fp32: the JAX package pins
``Precision.HIGHEST`` because the BMU argmin is sensitive to reduced
precision. On the GPU a float32 matmul may go through TF32 when the
caller's process has switched it on, so each matmul runs under
:func:`fp32_matmul`, which turns TF32 off and restores the caller's
setting afterwards.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = [
    "fp32_matmul",
    "euclidean_squared_distance_part",
    "DistanceFunction",
    "DISTANCE_NAMES",
]

DISTANCE_NAMES = (
    "euclidean",
    "euclidean_no_opt",
    "manhattan",
    "manhattan_no_opt",
    "cosine",
    "norm_p",
    "norm_p_no_opt",
)


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


def euclidean_squared_distance_part(x, w, w_sq=None):
    """Partial squared L2: ``-2 x@Wᵀ + ‖w‖²`` (argmin-equivalent to the
    full squared distance)."""
    if w_sq is None:
        w_sq = _w_sq(w)
    with fp32_matmul():
        cross = x.float() @ w.float().T
    return -2.0 * cross + w_sq.reshape(1, -1)


class DistanceFunction:
    """Name → distance dispatcher. This slice serves ``'euclidean'``."""

    def __init__(self, name, kwargs=None):
        if name not in DISTANCE_NAMES:
            raise ValueError(
                "%s not supported. Distances available: %s"
                % (name, ", ".join(DISTANCE_NAMES))
            )
        if name != "euclidean":
            raise NotImplementedError(
                f"activation_distance={name!r} is not ported yet "
                "(ROADMAP Queue 1 item 6); the port serves 'euclidean'"
            )
        self.name = name
        self.kwargs = dict(kwargs or {})
        self.can_cache = True

    def flat(self, x, w_flat, w_flat_sq=None):
        """Apply to an already-flattened ``(XY, D)`` codebook."""
        return euclidean_squared_distance_part(x, w_flat, w_flat_sq)

    def __call__(self, x, w, w_flat_sq=None):
        return self.flat(x, w.reshape(-1, w.shape[-1]), w_flat_sq)
