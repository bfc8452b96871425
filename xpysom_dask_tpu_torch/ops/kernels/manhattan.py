"""The L1 distance matrix: the K8 wrapper and its plain PyTorch version.

Counterpart of ``xpysom_dask_tpu/ops/pallas/manhattan.py``: the full
(N, XY) matrix ``Σ_d |x_n − w_j|`` that ``ops/distances.manhattan_distance``
returns, and through it ``XPySom.activate`` under the manhattan
activation. The kernel (``csrc/manhattan.cu``) and the plain version both
add the terms over d in index order from 0, as the Pallas kernel does, so
all three agree bit for bit.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..distances import manhattan_distance_no_opt
from . import build
from .tile import check_tile_operands

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
    output; K5's register tiling with a store epilogue (csrc/manhattan.cu
    on csrc/tile_argmin.cuh)."""
    check_tile_operands(x, w)
    if x.device.type == "cpu":
        return manhattan_distance_plain(x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the tile kernels take contiguous operands")
    n, d = x.shape
    xy = w.shape[0]
    if max(n, d, xy) >= 2**31:
        raise ValueError("operand sizes must fit 32-bit ints")
    out = torch.empty((n, xy), dtype=torch.float32, device=x.device)
    rc = build.load_library().xps_manhattan_distance(
        x.data_ptr(), w.data_ptr(), n, d, xy, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "manhattan_distance")
    manhattan_distance.launches += 1
    return out


manhattan_distance.launches = 0
