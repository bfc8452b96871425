"""Fused BMU search + per-BMU statistics: the K10 wrapper, its plain
PyTorch version, and one epoch's statistics through it.

Counterpart of ``bmu_stats_fused`` in
``xpysom_dask_tpu/ops/pallas/fused_stats.py``: the packed-mode winners of
one chunk and the fresh (XY, D+1) f32 partial ``acc[b] = Σ_{n: idx_n = b}
[x_n | 1]·m_n`` in one launch. As the JAX function, it does not center:
the codebook is packed as given (``PackedCodebook(w, 'packed',
center=False)``), whereas training centers by the codebook mean. The
winners are K1's on those operands and ``acc`` is K9's on those winners,
bit for bit: each node's rows are added in row order from 0.0. No
training route dispatches it, as no JAX path does; :func:`epoch_stats`
runs one epoch's statistics through it or through K1 + K9 for comparison.

The JAX module's ``fits_budget`` (a Mosaic VMEM formula) and ``tiles=``
are not ported: the kernel keeps one node range's accumulator in shared
memory and loops over ranges, so only one node's row must fit.
"""

from __future__ import annotations

import torch

from . import build
from .bmu import (
    PackedCodebook,
    _check_kernel_layout,
    _check_operands,
    bmu_argmin_plain,
)
from .stats import scatter_stats, scatter_stats_plain

__all__ = ["bmu_stats_fused", "bmu_stats_fused_plain", "epoch_stats"]


def _packed(w):
    """The uncentered packed codebook of ``w``: the (XY, D) codebook, or
    such a ``PackedCodebook`` built once for many chunks."""
    if isinstance(w, PackedCodebook):
        if w.mode != "packed" or w.center is not None:
            raise ValueError("the fused search takes an uncentered 'packed' codebook")
        return w
    if w.dim() != 2:
        raise ValueError(f"w_flat (XY, D) expected, got {tuple(w.shape)}")
    return PackedCodebook(w, "packed", center=False)


def _check(x, mask):
    if x.dim() != 2 or mask.shape != (x.shape[0],):
        raise ValueError(f"x (N, D) and mask (N,) expected, got {tuple(x.shape)}, "
                         f"{tuple(mask.shape)}")
    if x.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"float32 x and mask required, got {x.dtype} and {mask.dtype}")
    if x.device != mask.device:
        raise ValueError("x and mask must share a device")


def bmu_stats_fused_plain(x, w_flat, mask):
    """Plain K10: K1's plain version on the uncentered packed operands,
    then K9's plain version on its winners."""
    _check(x, mask)
    a, w_aug, xy = _packed(w_flat).operands(x)
    idx, _ = bmu_argmin_plain(a, w_aug, xy)
    return idx, scatter_stats_plain(x, mask, idx, xy)


def bmu_stats_fused(x, w_flat, mask):
    """K10: ``(idx (N,) int32, acc (XY, D+1) f32)``, the packed winners of
    the samples ``x`` (N, D) against ``w_flat`` (the (XY, D) codebook or
    its uncentered packed ``PackedCodebook``) and ``acc = [S | cnt]`` of
    the rows weighted by ``mask`` (N,). Masked rows contribute nothing;
    their winners are still returned.

    Source note: replaces ``_kernel`` of xpysom_dask_tpu/ops/pallas/
    fused_stats.py. One cooperative launch (csrc/fused_stats.cu): K1's
    search over persistent 64-row blocks, one grid barrier, then each
    block sums a contiguous node range in shared memory, each node's rows
    in row order (warp ballots over the winners): deterministic, atomic
    free, K1's winners and K9's bits. Phase 1 is bound by the tensor cores
    as K1; phase 2 by reading the rows and scanning the winners. Raises
    where one node's (D+1)-float row does not fit the kernel's shared
    memory (D in the thousands)."""
    _check(x, mask)
    cb = _packed(w_flat)
    if x.device.type == "cpu":
        return bmu_stats_fused_plain(x, cb, mask)
    a, w_aug, xy = cb.operands(x)
    _check_operands(a, w_aug, xy)
    _check_kernel_layout(a, w_aug)
    n, d = x.shape
    if n * d >= 2**31 or xy * (d + 1) >= 2**31:
        raise ValueError("operands too large for 32-bit kernel indexing")
    x = x.contiguous()
    mask = mask.contiguous()
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    val = torch.empty(n, dtype=torch.float32, device=x.device)
    acc = torch.empty((xy, d + 1), dtype=torch.float32, device=x.device)
    rc = build.load_library().xps_bmu_stats_fused(
        a.data_ptr(), w_aug.data_ptr(), x.data_ptr(), mask.data_ptr(), n, a.shape[1], xy,
        w_aug.shape[1], d, idx.data_ptr(), val.data_ptr(), acc.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "bmu_stats_fused")
    bmu_stats_fused.launches += 1
    return idx, acc


bmu_stats_fused.launches = 0


def epoch_stats(w_flat, data, mask, fused=True):
    """One epoch's ``(S, cnt)`` over the chunks ``data`` (C, chunk, D) with
    masks ``mask`` (C, chunk), searched against the uncentered packed
    codebook of ``w_flat`` (XY, D): each chunk's fresh partial from K10
    (``fused``) or from K1 then K9, added into the running total in chunk
    order (the JAX anatomy tool's ``stats_fused`` epoch). On CPU tensors
    the wrappers run their plain versions."""
    cb = _packed(w_flat)
    d = data.shape[-1]
    acc = torch.zeros((cb.xy, d + 1), dtype=torch.float32, device=data.device)
    for c in range(data.shape[0]):
        x, m = data[c], mask[c]
        if fused:
            _, part = bmu_stats_fused(x, cb, m)
        else:
            idx, _ = cb.argmin(x)  # K1, on the codebook laid out once
            part = scatter_stats(x, m, idx, cb.xy)
        acc = acc + part
    return acc[:, :d], acc[:, d]
