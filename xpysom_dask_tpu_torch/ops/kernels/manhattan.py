"""The L1 distance matrix: the K8 wrapper and its plain PyTorch version.

Counterpart of ``xpysom_dask_tpu/ops/pallas/manhattan.py``: the full
(N, XY) matrix ``Σ_d |x_n − w_j|`` that ``ops/distances.manhattan_distance``
returns, and through it ``XPySom.activate`` under the manhattan
activation. The kernel (``csrc/manhattan.cu``, on K5's engine
``csrc/tile_argmin.cuh``) and the plain version both
add the terms over d in index order from 0, as the Pallas kernel does, so
all three agree bit for bit.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from ..distances import manhattan_distance_no_opt
from .tile import check_tile_operands, launch_tile_store

__all__ = ["manhattan_distance", "manhattan_distance_plain"]


def manhattan_distance_plain(x, w):
    """Plain K8: ``Σ_d |x_d − w_d|`` into an (N, XY) accumulator, d by d
    (the broadcast form, ``manhattan_distance_no_opt``)."""
    return manhattan_distance_no_opt(x, w)


def manhattan_distance(x, w):
    """K8: the (N, XY) f32 L1 distance matrix of ``x`` (N, D) against the
    codebook rows ``w`` (XY, D).

    Source note: replaces ``_kernel`` of xpysom_dask_tpu/ops/pallas/
    manhattan.py. Bound by the FP32 pipes on the H100 (two instructions
    per term, 1.7e10 terms per flagship chunk) ahead of its 1.07 GB of
    output; K5's engine with a store epilogue (csrc/manhattan.cu on
    csrc/tile_argmin.cuh), the codebook laid out per call and cut into
    segments so that activate's 1024-row chunks fill the card."""
    check_tile_operands(x, w)
    if x.device.type == "cpu":
        return manhattan_distance_plain(x, w)
    out = launch_tile_store("xps_manhattan_distance", x, w)
    manhattan_distance.launches += 1
    return out


manhattan_distance.launches = 0
