"""Elementwise BMU searches: the K5 (L1), K6 (odd p) and K7 (fractional p)
wrappers and their plain PyTorch versions.

Counterpart of ``bmu_manhattan``, ``bmu_norm_p_odd`` and ``bmu_norm_p_frac``
in ``xpysom_dask_tpu/ops/pallas/bmu.py``: ``(idx, val)`` per sample row,
``idx`` the first-index argmin over the codebook rows of
``Σ_d term(|x_d − w_d|)`` and ``val`` that sum (the p-th-power distance
for norm_p). The sum runs over d in index order in one f32 accumulator in
the kernels (``csrc/elementwise.cu`` on the engine of
``csrc/tile_argmin.cuh``) and in the plain versions alike, so K5 and K6
give their plain versions' bits. K7 takes ``t^f`` from the card's
special-function unit (``sqrt.approx``, or ``ex2.approx(f·lg2.approx t)``)
where the plain version calls IEEE ``sqrt`` or the accurate ``exp`` and
``log``. Measured on an H100 over 2^21 values of t (``chip_smoke.py``'s
term sweep), its term errs by at most 3.8e-6 relative to float64 ``t^p``
(p = 0.3; the plain version 3.2e-6), 2.0e-7 through the sqrt branch, and
stays within 6.2e-6 of the plain version's; ``chip_smoke.py`` holds its
values to the plain version's within 1e-5 relative.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (through ``tile.launch_tile_argmin``) or raises.
"""

from __future__ import annotations

import math

import torch

from ..distances import sum_over_d
from .tile import EW_BN, check_tile_operands, first_argmin, launch_tile_argmin, lay_out_f32

__all__ = [
    "bmu_manhattan",
    "bmu_manhattan_plain",
    "bmu_norm_p_odd",
    "bmu_norm_p_odd_plain",
    "bmu_norm_p_frac",
    "bmu_norm_p_frac_plain",
    "ElementwiseCodebook",
]

_F32 = torch.float32


def _odd_p(p) -> int:
    if not float(p).is_integer() or p < 1 or int(p) % 2 == 0:
        raise ValueError(f"p={p} must be a positive odd integer")
    return int(p)


def _frac_p(p):
    """``(m, f, half)``: ``p = m + f`` with ``m = ⌊p⌋``; ``half`` selects
    the sqrt branch (``f == 0.5``, decided in float64 as the JAX kernel
    decides it)."""
    p = float(p)
    if not p > 0 or p.is_integer():
        raise ValueError(
            f"p={p} must be a positive non-integer (odd/even integer p "
            "ride bmu_norm_p_odd / bmu_norm_p_even)"
        )
    m = int(math.floor(p))
    f = p - m
    return m, f, f == 0.5


def bmu_manhattan_plain(x, w):
    """Plain K5: ``Σ_d |x_d − w_d|`` into an (N, XY) accumulator, d by d."""
    return first_argmin(sum_over_d(x, w, lambda t: t))


def bmu_norm_p_odd_plain(x, w, p=3):
    """Plain K6: ``t^p`` by the multiply chain ``tp = t; tp = tp·t``."""
    p = _odd_p(p)

    def term(t):
        tp = t.clone()
        for _ in range(p - 1):
            tp.mul_(t)
        return tp

    return first_argmin(sum_over_d(x, w, term))


def bmu_norm_p_frac_plain(x, w, p=1.5):
    """Plain K7: ``sqrt(t)`` (fraction ½) or ``exp(f·log t)``, then ⌊p⌋
    multiplies by t."""
    m, f, half = _frac_p(p)
    f32 = torch.tensor(f, dtype=_F32)

    def term(t):
        tp = torch.sqrt(t) if half else torch.exp(torch.log(t) * f32.to(t.device))
        for _ in range(m):
            tp.mul_(t)
        return tp

    return first_argmin(sum_over_d(x, w, term))


def bmu_manhattan(x, w, w_laid=None):
    """K5: the first-index L1 BMU ``(idx, val)`` of each row of ``x`` (N, D)
    over the codebook ``w`` (XY, D), exact f32. ``w_laid``: the codebook
    laid out for the engine (``lay_out_f32(w, EW_BN)``, which
    ``ElementwiseCodebook`` makes once); without it the call lays it out.

    Source note: replaces ``_kernel_manhattan_argmin`` (accum='serial') of
    xpysom_dask_tpu/ops/pallas/bmu.py. Bound by the FP32 pipes on the H100
    (two instructions per term, 8 MB of operands per flagship chunk): the
    samples resident in shared memory, the codebook streamed by bulk copies
    on mbarriers, an 8 x 8 register tile per thread fed by 16-byte
    shared-memory vectors, the running argmin in registers, the codebook
    cut into segments where the rows alone would leave SMs idle
    (csrc/elementwise.cu, csrc/tile_argmin.cuh)."""
    check_tile_operands(x, w)
    if x.device.type == "cpu":
        return bmu_manhattan_plain(x, w)
    out = launch_tile_argmin("xps_bmu_manhattan", x, w, w_laid=w_laid)
    bmu_manhattan.launches += 1
    return out


bmu_manhattan.launches = 0


def bmu_norm_p_odd(x, w, p=3, w_laid=None):
    """K6: the first-index BMU under ``Σ_d |x_d − w_d|^p`` for odd ``p``
    (integer-valued floats accepted); ``val`` is the p-th-power distance.
    ``w_laid`` as for :func:`bmu_manhattan`.

    Source note: replaces ``_kernel_lp_odd_argmin`` of xpysom_dask_tpu/
    ops/pallas/bmu.py; K5's engine with the multiply chain ``tp = tp·t``
    (p − 1 times: unrolled for p = 3, a run-time count otherwise) run over
    a row's 8 terms together and explicitly rounded so no FMA forms."""
    check_tile_operands(x, w)
    p = _odd_p(p)
    if x.device.type == "cpu":
        return bmu_norm_p_odd_plain(x, w, p)
    out = launch_tile_argmin("xps_bmu_lp_odd", x, w, p, w_laid=w_laid)
    bmu_norm_p_odd.launches += 1
    return out


bmu_norm_p_odd.launches = 0


def bmu_norm_p_frac(x, w, p=1.5, w_laid=None):
    """K7: the first-index BMU under ``Σ_d |x_d − w_d|^p`` for non-integer
    ``p > 0``; ``val`` is the p-th-power distance. ``w_laid`` as for
    :func:`bmu_manhattan`.

    Source note: replaces ``_kernel_lp_frac_argmin`` of xpysom_dask_tpu/
    ops/pallas/bmu.py; K5's engine with ``sqrt.approx`` (fraction ½) or
    ``ex2.approx(f·lg2.approx t)`` per term on the special-function unit,
    then ⌊p⌋ rounded multiplies by t (unrolled for ⌊p⌋ ≤ 2), the same chain
    as K6's. The special-function unit bounds it on the H100."""
    check_tile_operands(x, w)
    m, f, half = _frac_p(p)
    if x.device.type == "cpu":
        return bmu_norm_p_frac_plain(x, w, p)
    out = launch_tile_argmin("xps_bmu_lp_frac", x, w, m, f, int(half), w_laid=w_laid)
    bmu_norm_p_frac.launches += 1
    return out


bmu_norm_p_frac.launches = 0

_SEARCHES = {
    "manhattan": (bmu_manhattan, bmu_manhattan_plain),
    "norm_p_odd": (bmu_norm_p_odd, bmu_norm_p_odd_plain),
    "norm_p_frac": (bmu_norm_p_frac, bmu_norm_p_frac_plain),
}


class ElementwiseCodebook:
    """The codebook side of an elementwise search (``kind`` one of
    ``'manhattan'``, ``'norm_p_odd'``, ``'norm_p_frac'``), built once per
    epoch or scoring call: the contiguous f32 codebook, ``p``, and on the
    card the codebook laid out for the engine once (:meth:`laid`)."""

    def __init__(self, w_flat, kind, p=None):
        self.w = w_flat.float().contiguous()
        self._fns = _SEARCHES[kind]
        self._args = () if kind == "manhattan" else (p,)
        self._laid = None

    def laid(self):
        """``lay_out_f32(w, EW_BN)``, made at the first call and kept."""
        if self._laid is None:
            self._laid = lay_out_f32(self.w, EW_BN)
        return self._laid

    def argmin(self, x, use_kernels=True):
        """``(idx, val)`` for samples ``x`` (N, D): the kernel, or its plain
        version when ``use_kernels`` is False."""
        x = x.float().contiguous()
        if not use_kernels:
            return self._fns[1](x, self.w, *self._args)
        if x.device.type == "cpu":
            return self._fns[0](x, self.w, *self._args)
        return self._fns[0](x, self.w, *self._args, w_laid=self.laid())
