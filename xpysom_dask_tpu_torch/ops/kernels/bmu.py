"""Packed BMU search: operand packing, the K1/K2 wrappers and their plain
PyTorch versions.

Counterpart of ``bmu_euclidean`` in mode ``packed`` in
``xpysom_dask_tpu/ops/pallas/bmu.py``. The partial squared distance
``d = -2 x·w + ‖w‖²`` comes out of ONE augmented bf16 GEMM:

    A     = [xh | xl | xh | 1 1 1]            (N, K)   bf16
    W_aug = [wh; wh; wl; s1; s2; s3]          (K, XY)  bf16

where ``(xh, xl)`` and ``(wh, wl)`` are bf16 splits of x and of ``-2wᵀ``
and ``s1 + s2 + s3 == ‖w‖²`` exactly; K = 3D+3 padded to a multiple of 16.
The dropped ``xl·wl`` term is O(2⁻¹⁶) relative, so the winner can differ
from the exact one only where two distances are within about
``2⁻¹⁷·Σ_d|x_d||2w_d|`` (a near-tie). ``PackedCodebook`` centers x and w
by the codebook mean first, which shrinks that bound on offset data.

The kernels (``csrc/bmu.cu``): K1 ``bmu_argmin`` replaces
``_kernel_gemm_argmin`` (``ops/pallas/bmu.py``) and K2 ``bmu_top2``
replaces ``_kernel_gemm_top2``. On a CPU tensor each wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..distances import fp32_matmul
from . import build

__all__ = [
    "split_bf16",
    "split3_bf16",
    "pack_codebook",
    "pack_samples",
    "bmu_argmin",
    "bmu_argmin_plain",
    "bmu_top2",
    "bmu_top2_plain",
    "PackedCodebook",
]

_BF16 = torch.bfloat16


def split_bf16(a):
    """Dekker-style bf16 split: ``a ≈ f32(hi) + f32(lo)`` (the same
    roundings as ``_split_bf16`` of the JAX package)."""
    hi = a.to(_BF16)
    return hi, (a - hi.float()).to(_BF16)


def split3_bf16(a):
    """Exact 3-term bf16 split of f32: ``a == f32(h) + f32(m) + f32(l)``
    (8+8+8 mantissa bits cover f32's 24; as ``_split3_bf16``)."""
    h = a.to(_BF16)
    r = a - h.float()
    m = r.to(_BF16)
    return h, m, (r - m.float()).to(_BF16)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_codebook(w_c, w_sq):
    """``W_aug`` (K16, XY8) bf16 from the centered (XY, D) f32 codebook and
    its (XY,) squared norms. Columns past XY (padding to a multiple of 8,
    so each row is 16-byte aligned) are zero; the kernels never rank
    them."""
    xy, d = w_c.shape
    k16 = _round_up(3 * d + 3, 16)
    wh, wl = split_bf16(-2.0 * w_c.float().T)
    s1, s2, s3 = split3_bf16(w_sq.float().reshape(1, xy))
    w_aug = torch.zeros((k16, _round_up(xy, 8)), dtype=_BF16, device=w_c.device)
    w_aug[: 3 * d + 3, :xy] = torch.cat([wh, wh, wl, s1, s2, s3], dim=0)
    return w_aug


def pack_samples(x_c):
    """``A`` (N, K16) bf16 from the centered (N, D) f32 samples."""
    n, d = x_c.shape
    k16 = _round_up(3 * d + 3, 16)
    xh, xl = split_bf16(x_c.float())
    a = torch.zeros((n, k16), dtype=_BF16, device=x_c.device)
    a[:, : 3 * d] = torch.cat([xh, xl, xh], dim=1)
    a[:, 3 * d : 3 * d + 3] = 1.0
    return a


def _distances_plain(a, w_aug, xy):
    with fp32_matmul():
        return a.float() @ w_aug[:, :xy].float()


def bmu_argmin_plain(a, w_aug, xy):
    """Plain K1: the augmented GEMM in fp32, then the first-index argmin."""
    d = _distances_plain(a, w_aug, xy)
    idx = torch.argmin(d, dim=1)
    return idx.to(torch.int32), torch.gather(d, 1, idx[:, None])[:, 0]


def bmu_top2_plain(a, w_aug, xy):
    """Plain K2: best and second-best (index, value) per row in
    stable-argsort order — the second is the first minimum once the
    winning column is excluded, so a duplicate minimum is the runner-up."""
    d = _distances_plain(a, w_aug, xy)
    i1 = torch.argmin(d, dim=1)
    v1 = torch.gather(d, 1, i1[:, None])[:, 0]
    d.scatter_(1, i1[:, None], float("inf"))
    i2 = torch.argmin(d, dim=1)
    v2 = torch.gather(d, 1, i2[:, None])[:, 0]
    return i1.to(torch.int32), v1, i2.to(torch.int32), v2


def _check_operands(a, w_aug, xy):
    if a.dtype != _BF16 or w_aug.dtype != _BF16:
        raise TypeError(f"bf16 operands required, got {a.dtype} and {w_aug.dtype}")
    if a.dim() != 2 or w_aug.dim() != 2 or a.shape[1] != w_aug.shape[0]:
        raise ValueError(
            f"A (N, K) and W_aug (K, XY) expected, got {tuple(a.shape)} and "
            f"{tuple(w_aug.shape)}"
        )
    if not 0 < xy <= w_aug.shape[1]:
        raise ValueError(f"xy={xy} out of range for W_aug {tuple(w_aug.shape)}")
    if a.device != w_aug.device:
        raise ValueError(f"operands on {a.device} and {w_aug.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _check_kernel_layout(a, w_aug):
    if not (a.is_contiguous() and w_aug.is_contiguous()):
        raise ValueError("the BMU kernels take contiguous operands")
    if a.shape[1] % 8 or w_aug.shape[1] % 8:
        raise ValueError(
            f"K={a.shape[1]} and the W_aug row stride {w_aug.shape[1]} must be "
            "multiples of 8 (16-byte rows)"
        )
    if a.data_ptr() % 16 or w_aug.data_ptr() % 16:
        raise ValueError("the BMU kernels take 16-byte aligned operands")
    if a.shape[0] >= 2**31 or w_aug.numel() >= 2**31:
        raise ValueError("operands too large for 32-bit kernel indexing")


def bmu_argmin(a, w_aug, xy):
    """K1: ``(idx, val)`` per row, ``idx`` the first-index argmin over the
    first ``xy`` columns of ``A @ W_aug`` and ``val`` its f32 value.

    Source note: replaces ``_kernel_gemm_argmin`` (xpysom_dask_tpu/ops/
    pallas/bmu.py). On the H100 the GEMM bounds it (5.6e10 multiply-adds
    per flagship chunk); the first version reaches the tensor cores
    through WMMA with shared-memory staging and folds each distance tile
    into a running (min, argmin) without writing it to device memory."""
    _check_operands(a, w_aug, xy)
    if a.device.type == "cpu":
        return bmu_argmin_plain(a, w_aug, xy)
    _check_kernel_layout(a, w_aug)
    n = a.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=a.device)
    val = torch.empty(n, dtype=torch.float32, device=a.device)
    lib = build.load_library()
    rc = lib.xps_bmu_argmin(
        a.data_ptr(), w_aug.data_ptr(), n, a.shape[1], xy, w_aug.shape[1],
        idx.data_ptr(), val.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(rc, "bmu_argmin")
    bmu_argmin.launches += 1
    return idx, val


bmu_argmin.launches = 0


def bmu_top2(a, w_aug, xy):
    """K2: ``(idx, val, idx2, val2)`` — the two best columns per row in
    stable-argsort order (value, then lowest index; a duplicate minimum is
    the runner-up with ``val2 == val``).

    Source note: replaces ``_kernel_gemm_top2`` (xpysom_dask_tpu/ops/
    pallas/bmu.py). Same GEMM and bound as K1; the finish carries two
    (value, index) pairs per row through the lane and tile merges."""
    _check_operands(a, w_aug, xy)
    if a.device.type == "cpu":
        return bmu_top2_plain(a, w_aug, xy)
    _check_kernel_layout(a, w_aug)
    n = a.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=a.device)
    val = torch.empty(n, dtype=torch.float32, device=a.device)
    idx2 = torch.empty(n, dtype=torch.int32, device=a.device)
    val2 = torch.empty(n, dtype=torch.float32, device=a.device)
    lib = build.load_library()
    rc = lib.xps_bmu_top2(
        a.data_ptr(), w_aug.data_ptr(), n, a.shape[1], xy, w_aug.shape[1],
        idx.data_ptr(), val.data_ptr(), idx2.data_ptr(), val2.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(rc, "bmu_top2")
    bmu_top2.launches += 1
    return idx, val, idx2, val2


bmu_top2.launches = 0


class PackedCodebook:
    """The codebook side of the packed BMU search, built once per epoch
    (or per scoring call) and shared by every chunk: the centering mean
    and ``W_aug``. Centering by the codebook mean leaves the argmin
    unchanged and shrinks the packed split's error floor on offset data
    (as the JAX core's euclidean route does)."""

    def __init__(self, w_flat):
        w_flat = w_flat.float()
        self.xy = w_flat.shape[0]
        self.center = torch.mean(w_flat, dim=0)
        w_c = w_flat - self.center[None, :]
        self.w_aug = pack_codebook(w_c, torch.sum(w_c * w_c, dim=1))

    def operands(self, x):
        """``(A, W_aug, xy)`` for samples ``x`` (N, D): the arguments of
        ``bmu_argmin``/``bmu_top2`` and their plain versions."""
        return pack_samples(x.float() - self.center[None, :]), self.w_aug, self.xy
