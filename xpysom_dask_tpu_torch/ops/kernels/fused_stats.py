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
are not ported: :func:`fused_plan` sizes the launch from the shapes and
the card's SM count, and any D runs (the scatter takes columns in passes
of at most 128).
"""

from __future__ import annotations

import collections

import torch

from . import build
from .bmu import GEMM_BK, GEMM_BM, K1_BN, PackedCodebook, bmu_argmin_plain
from .stats import MAX_NODES, _sm_count, scatter_stats, scatter_stats_plain, smem_bytes

__all__ = ["bmu_stats_fused", "bmu_stats_fused_plain", "epoch_stats", "fused_plan", "FusedPlan"]

# K1's ring (csrc/gemm_sm90.cuh Cfg<ARGMIN>::SMEM_BYTES): four stages of a
# streamed A chunk and a codebook chunk, bf16
K1_RING_BYTES = 4 * (GEMM_BM + K1_BN) * GEMM_BK * 2
# csrc/fused_stats.cu: phase 2's groups of 256 threads per block, and the
# dynamic shared memory a block may take (227 KB less its static barriers)
GROUPS = 2
MAX_SMEM = 227 * 1024 - 1024

FusedPlan = collections.namedtuple("FusedPlan", "grid row_blocks nodes ranges smem")


def group_bytes(nodes, d):
    """One phase-2 group's shared memory (csrc/fused_stats.cu
    ``group_bytes``): K9's for ranges of ``nodes`` nodes, rounded up to 128
    bytes."""
    return -(-smem_bytes(nodes, d) // 128) * 128


def fused_plan(n, xy, d, sms):
    """K10's launch on a card with ``sms`` SMs, as a :class:`FusedPlan`:
    ``grid`` blocks of 512 threads, one per SM. Phase 1 gives block b the
    ``GEMM_BM``-row blocks b, b + grid, ... of the ``row_blocks``, searched
    by its first 288 threads (K1's block); phase 2 gives group g of its two
    groups of 256 threads the node ranges 2b + g, 2b + g + 2·grid, ... of
    the ``ranges``, each ``nodes`` consecutive nodes (the last one fewer):
    about one range per group, at most ``MAX_NODES`` nodes and as many as
    let both groups' shared memory fit. ``smem``: the dynamic shared
    memory, the larger of phase 1's ring and phase 2's two groups
    (csrc/stats.cuh: each a range's sums of a column pass, its lists and
    staging), which reuse the ring."""
    nodes = min(MAX_NODES, max(1, -(-xy // (GROUPS * sms))))
    while nodes > 1 and GROUPS * group_bytes(nodes, d) > MAX_SMEM:
        nodes -= 1
    return FusedPlan(sms, -(-n // GEMM_BM), nodes, -(-xy // nodes),
                     max(K1_RING_BYTES, GROUPS * group_bytes(nodes, d)))


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
    fused_stats.py. One cooperative launch (csrc/fused_stats.cu) on K1's
    operands as ``PackedCodebook.argmin`` feeds K1 (the codebook laid out
    once per object, the samples packed and laid out in one pass): K1's
    wgmma search over persistent 128-row blocks, one grid barrier, then
    K9's scatter over node ranges, two groups per block
    (:func:`fused_plan`): deterministic, atomic free, K1's winners and
    K9's bits. Phase 1 is bound by the tensor cores as K1; phase 2 by
    reading the rows, and under skew by a long run's add chain, as K9."""
    _check(x, mask)
    cb = _packed(w_flat)
    if x.device.type == "cpu":
        return bmu_stats_fused_plain(x, cb, mask)
    if x.device.type != "cuda" or cb.w_aug.device != x.device:
        raise ValueError(f"x on {x.device} and the codebook on {cb.w_aug.device}: one CUDA "
                         "device expected")
    n, d = x.shape
    if n * d >= 2**31 or cb.xy * (d + 1) >= 2**31:
        raise ValueError("operands too large for 32-bit kernel indexing")
    x = x.contiguous()
    return cb._on_card(_launch_k10, x, "packed", cb.laid()[0], x, mask.contiguous())


def _launch_k10(a_laid, w_laid, n, k, xy, x, mask):
    """K10 on K1's laid-out operands (``a_laid`` of ``x``), counted on
    ``bmu_stats_fused``."""
    d = x.shape[1]
    plan = fused_plan(n, xy, d, _sm_count(x.device.index or 0))
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    val = torch.empty(n, dtype=torch.float32, device=x.device)
    acc = torch.empty((xy, d + 1), dtype=torch.float32, device=x.device)
    rc = build.load_library().xps_bmu_stats_fused(
        a_laid.data_ptr(), w_laid.data_ptr(), x.data_ptr(), mask.data_ptr(), n,
        -(-k // 16) * 16, xy, d, plan.grid, plan.nodes, plan.smem, idx.data_ptr(),
        val.data_ptr(), acc.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
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
