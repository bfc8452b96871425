"""GEMM-form BMU searches: operand packing, the K1/K2 (packed) and K4
(highest) wrappers with their plain PyTorch versions, and the cosine and
even-p norm_p glue that rides them.

Counterpart of ``bmu_euclidean`` (modes ``packed`` and ``highest``),
``bmu_cosine`` and ``bmu_norm_p_even`` in
``xpysom_dask_tpu/ops/pallas/bmu.py``. Mode ``packed`` computes the
partial squared distance ``d = -2 x·w + ‖w‖²`` as ONE augmented bf16 GEMM:

    A     = [xh | xl | xh | 1 1 1]            (N, K)   bf16
    W_aug = [wh; wh; wl; s1; s2; s3]          (K, XY)  bf16

where ``(xh, xl)`` and ``(wh, wl)`` are bf16 splits of x and of ``-2wᵀ``
and ``s1 + s2 + s3 == ‖w‖²`` exactly; K = 3D+3 padded to a multiple of 16.
The dropped ``xl·wl`` term is O(2⁻¹⁶) relative, so the winner can differ
from the exact one only where two distances are within about
``2⁻¹⁷·Σ_d|x_d||2w_d|`` (a near-tie). Mode ``highest`` computes the same
``d`` with an exact f32 dot.

``PackedCodebook`` owns the codebook side of every GEMM-form search:
centering by the codebook mean (which shrinks the packed split's error on
offset data; :func:`center_by_mean` is the one rule, which the norm_p
expansion applies before it expands), a raw ``‖w‖²`` operand where the
caller's distance is not euclidean (cosine and the norm_p expansion pass
zero), and the packing. ``NormPEvenCodebook`` expands both sides and
searches through a ``PackedCodebook``.

The kernels: K1 ``bmu_argmin`` replaces ``_kernel_gemm_argmin``, K2
``bmu_top2`` replaces ``_kernel_gemm_top2`` (``csrc/bmu.cu``) and K4
``bmu_highest`` replaces ``_kernel_highest`` (``csrc/highest.cu``). On a
CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..distances import fp32_matmul
from . import build
from .tile import check_tile_operands, first_argmin, launch_tile_argmin

__all__ = [
    "split_bf16",
    "split3_bf16",
    "pack_codebook",
    "pack_samples",
    "bmu_argmin",
    "bmu_argmin_plain",
    "bmu_top2",
    "bmu_top2_plain",
    "bmu_highest",
    "bmu_highest_plain",
    "bmu_cosine",
    "bmu_norm_p_even",
    "center_by_mean",
    "cosine_codebook",
    "NormPEvenCodebook",
    "PackedCodebook",
    "GEMM_MODES",
]

_BF16 = torch.bfloat16
_F32 = torch.float32
# the precision modes the GEMM-form searches serve
GEMM_MODES = ("packed", "highest")


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
    return first_argmin(_distances_plain(a, w_aug, xy))


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


def bmu_highest_plain(x, w, w_sq):
    """Plain K4: ``-2·x·wᵀ + ‖w‖²`` with an fp32 matmul (no TF32), then the
    first-index argmin."""
    with fp32_matmul():
        cross = x @ w.T
    return first_argmin(-2.0 * cross + w_sq[None, :])


def bmu_highest(x, w, w_sq):
    """K4: ``(idx, val)`` per row of ``x`` (N, D), ``idx`` the first-index
    argmin over the codebook rows ``w`` (XY, D) of ``-2·x·w + w_sq`` in
    exact f32 and ``val`` its value.

    Source note: replaces ``_kernel_highest`` (xpysom_dask_tpu/ops/pallas/
    bmu.py, ``Precision.HIGHEST``). On the H100 the FP32 pipes bound it
    (1.7e10 FMAs per flagship chunk, no tensor cores: TF32 would lose the
    exactness the mode exists for); a register-tiled FFMA search with the
    running argmin in registers (csrc/highest.cu, csrc/tile_argmin.cuh)."""
    check_tile_operands(x, w, w_sq)
    if w_sq.shape != (w.shape[0],):
        raise ValueError(f"w_sq (XY,) expected, got {tuple(w_sq.shape)}")
    if x.device.type == "cpu":
        return bmu_highest_plain(x, w, w_sq)
    out = launch_tile_argmin("xps_bmu_highest", x, w, operands=(w_sq,))
    bmu_highest.launches += 1
    return out


bmu_highest.launches = 0


def center_by_mean(w_flat):
    """``(c, w − c)``: the codebook mean ``c`` (D,) and the centered f32
    codebook. Subtracting ``c`` from both sides leaves every euclidean and
    norm_p argmin unchanged and shrinks the terms the searches round."""
    w_flat = w_flat.float()
    c = torch.mean(w_flat, dim=0)
    return c, w_flat - c[None, :]


class PackedCodebook:
    """The codebook side of a GEMM-form BMU search (K1/K2 in mode
    ``'packed'``, K4 in mode ``'highest'``), built once per epoch or
    scoring call and shared by every chunk.

    ``center=True`` subtracts the codebook mean from both sides
    (:func:`center_by_mean`). ``w_sq`` overrides the ``‖w‖²`` operand with
    caller-defined semantics (the JAX package's ``w_sq_raw=True``): cosine
    and the norm_p expansion pass zeros."""

    def __init__(self, w_flat, mode="packed", *, center=True, w_sq=None):
        if mode not in GEMM_MODES:
            raise ValueError(f"mode={mode!r}: the GEMM-form searches serve {GEMM_MODES}")
        w_flat = w_flat.float()
        self.xy = w_flat.shape[0]
        self.mode = mode
        self.center, w_c = center_by_mean(w_flat) if center else (None, w_flat)
        w_sq = torch.sum(w_c * w_c, dim=1) if w_sq is None else w_sq.float().reshape(self.xy)
        if mode == "packed":
            self.w_aug = pack_codebook(w_c, w_sq)
        else:
            self.w = w_c.contiguous()
            self.w_sq = w_sq.contiguous()

    def operands(self, x):
        """The arguments of the mode's kernel (and of its plain version)
        for samples ``x`` (N, D): ``(A, W_aug, xy)`` for
        ``bmu_argmin``/``bmu_top2`` or ``(x', w, w_sq)`` for
        ``bmu_highest``."""
        x = x.float()
        if self.center is not None:
            x = x - self.center[None, :]
        if self.mode == "packed":
            return pack_samples(x), self.w_aug, self.xy
        return x.contiguous(), self.w, self.w_sq

    def argmin(self, x, use_kernels=True):
        """``(idx, val)``: the mode's kernel, or its plain version when
        ``use_kernels`` is False."""
        if self.mode == "packed":
            fn = bmu_argmin if use_kernels else bmu_argmin_plain
        else:
            fn = bmu_highest if use_kernels else bmu_highest_plain
        return fn(*self.operands(x))

    def top2(self, x, use_kernels=True):
        """K2's ``(idx, val, idx2, val2)``; mode ``'packed'`` only."""
        if self.mode != "packed":
            raise ValueError("the top-2 search runs in mode 'packed'")
        fn = bmu_top2 if use_kernels else bmu_top2_plain
        return fn(*self.operands(x))


def cosine_codebook(w_flat, mode="packed"):
    """The cosine search as a GEMM-form search: with the row-normalized
    codebook ``ŵ`` (a zero row stays zero), ``ŵ/2`` and a zero ``‖w‖²``
    the kernel computes ``-2·x·(ŵ/2) + 0 = -x·ŵ``, whose first-index
    argmin is the cosine argmin (``‖x‖`` is a positive per-row constant).
    No centering: cosine is not translation invariant."""
    w_flat = w_flat.float()
    w_norm = torch.sqrt(torch.sum(w_flat * w_flat, dim=1, keepdim=True))
    safe = torch.where(w_norm > 0, w_norm, torch.ones_like(w_norm))
    w_hat = torch.where(w_norm > 0, w_flat / safe, torch.zeros_like(w_flat))
    zeros = torch.zeros(w_flat.shape[0], dtype=_F32, device=w_flat.device)
    return PackedCodebook(0.5 * w_hat, mode, center=False, w_sq=zeros)


def bmu_cosine(x, w_flat, mode="packed", use_kernels=True):
    """``(idx, dist)`` under the cosine activation: ``idx`` the first-index
    argmin of ``1 − x·w / (‖x‖‖w‖)`` and ``dist`` that distance
    (``nan_to_num`` on the similarity: an all-zero sample has distance 1
    everywhere and takes index 0)."""
    idx, negdot = cosine_codebook(w_flat, mode).argmin(x, use_kernels)
    x = x.float()
    x_norm = torch.sqrt(torch.sum(x * x, dim=1))
    return idx, 1.0 - torch.nan_to_num(-negdot / x_norm)


def _binomial_coeffs(p):
    """``(−1)^e C(p, e)`` for e = 0..p."""
    coeffs, k = [], 1
    for e in range(p + 1):
        coeffs.append((-1.0 if e % 2 else 1.0) * k)
        k = (k * (p - e)) // (e + 1)
    return coeffs


class NormPEvenCodebook:
    """The even-p norm_p search as a GEMM-form search: ``Σ_d (x_d − w_d)^p
    = φ(x)·ψ(w)`` with ``φ(x) = [x^p | x^(p−1) | … | 1]`` and
    ``ψ(w) = [C(p,e)(−1)^e w^e]_e``, both of width D(p+1). With ``−ψ/2`` and
    a zero ``‖w‖²`` the kernel computes exactly ``φ·ψ``. Both sides are
    centered by the codebook mean first: the expansion cancels
    catastrophically and centering shrinks every term, which is also why
    the default mode is ``'highest'``."""

    def __init__(self, w_flat, p=2, mode="highest"):
        if not float(p).is_integer() or int(p) % 2 != 0 or int(p) < 2:
            raise ValueError("p must be even and >= 2")
        if mode == "margin":
            raise ValueError(
                "mode='margin' is not supported for the norm_p expansion; "
                "use 'highest' (the default)"
            )
        self.p = int(p)
        self.center, wc = center_by_mean(w_flat)
        psi = torch.cat([cf * wc**e for e, cf in enumerate(_binomial_coeffs(self.p))], dim=1)
        zeros = torch.zeros(wc.shape[0], dtype=_F32, device=wc.device)
        self._gemm = PackedCodebook(-0.5 * psi, mode, center=False, w_sq=zeros)

    def _phi(self, x):
        xc = x.float() - self.center[None, :]
        return torch.cat([xc ** (self.p - e) for e in range(self.p + 1)], dim=1)

    def operands(self, x):
        """The mode's kernel arguments for samples ``x`` (N, D): those of
        the GEMM-form search over ``φ(x)``."""
        return self._gemm.operands(self._phi(x))

    def argmin(self, x, use_kernels=True):
        """``(idx, dist_p)``: the kernel, or its plain version when
        ``use_kernels`` is False."""
        return self._gemm.argmin(self._phi(x), use_kernels)


def bmu_norm_p_even(x, w_flat, p=2, mode="highest", use_kernels=True):
    """``(idx, dist_p)`` under the even-p norm_p activation: the first-index
    argmin of ``Σ_d (x_d − w_d)^p`` and that distance (the p-th power),
    through K4 (mode ``'highest'``) or K1 (``'packed'``)."""
    return NormPEvenCodebook(w_flat, p, mode).argmin(x, use_kernels)
