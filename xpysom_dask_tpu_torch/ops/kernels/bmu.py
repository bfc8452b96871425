"""GEMM-form BMU searches: operand packing for every precision mode, the
K1/K2 (packed, bf16, split2), K1-kb (packed, bf16; K summed in slabs), K3
(split3) and K4 (highest) wrappers with
their plain PyTorch versions, mode ``margin``'s rescue around K2 and K1,
and the cosine and even-p norm_p glue that rides them.

Counterpart of ``bmu_euclidean`` (every mode), ``_margin_rescue``,
``bmu_cosine`` and ``bmu_norm_p_even`` in
``xpysom_dask_tpu/ops/pallas/bmu.py``. Every mode computes the partial
squared distance ``d = -2 x·w + ‖w‖²``; the GEMM modes fold it into ONE
augmented bf16 GEMM ``A @ W_aug`` (K padded to a multiple of 16):

    packed  A = [xh | xl | xh | 1 1 1]   W_aug = [wh; wh; wl; s1; s2; s3]
    bf16    A = [x_bf16 | 1 1 1]         W_aug = [(-2wᵀ)_bf16; s1; s2; s3]
    split2  A = [xh | xl | 1 1 1]        W_aug = [wh; wh; s1; s2; s3]

where ``(xh, xl)`` and ``(wh, wl)`` are bf16 splits of x and of ``-2wᵀ``
and ``s1 + s2 + s3 == ‖w‖²`` exactly. ``packed`` drops only ``xl·wl``
(O(2⁻¹⁶) relative): a winner can differ from the exact one only where two
distances are within about ``2⁻¹⁷·Σ_d|x_d||2w_d|`` (a near-tie). ``bf16``
is the single-pass throughput mode (~2⁻⁸ relative). ``split2`` solves the
problem for the bf16-rounded codebook: its ``‖w‖²`` is ``¼·Σ wh²`` of the
ROUNDED codebook, unless the caller's ``w_sq`` has other semantics
(cosine, norm_p), which is then split exactly (the JAX ``w_sq_raw``).
``split3`` takes the pre-split ``xh, xl`` and ``wh, wl`` of ``wᵀ`` and an
unsplit f32 ``‖w‖²`` and sums three separate f32-accumulated dots in the
order ``(xh·wh + xh·wl) + xl·wh`` (K3): a different order than packed's
single chain, which can flip float64 near-ties. ``highest`` computes the
same ``d`` at f32 accuracy (K4: three TF32 tensor-core passes).
``margin`` runs the bf16 operands through K2, then re-ranks only the rows
whose top-2 margin lies inside the bf16 error bound with packed K1
(:func:`margin_rescue`).

``PackedCodebook`` owns the codebook side of every GEMM-form search:
centering by the codebook mean (which shrinks the split modes' error on
offset data; :func:`center_by_mean` is the one centering rule, which the
norm_p expansion applies before it expands), a raw ``‖w‖²`` operand where
the caller's distance is not euclidean (cosine and the norm_p expansion
pass zero), and the packing. ``NormPEvenCodebook`` expands both sides and
searches through a ``PackedCodebook``.

The kernels: K1 ``bmu_argmin`` replaces ``_kernel_gemm_argmin``, K1-kb
``bmu_argmin_kb`` replaces ``_kernel_gemm_argmin_kb`` (K1 with K summed
slab by slab, reached through ``PackedCodebook.argmin(kblock=)``), K2
``bmu_top2`` replaces ``_kernel_gemm_top2`` and K3 ``bmu_split3`` replaces
``_kernel_split3`` (four instances of one template, ``csrc/gemm_bmu.cuh``,
launched from ``csrc/bmu.cu``); K4 ``bmu_highest`` replaces
``_kernel_highest`` (``csrc/highest.cu``). On a CPU tensor each wrapper
runs its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from ..distances import fp32_matmul
from . import build
from .tile import check_tile_operands, first_argmin

__all__ = [
    "split_bf16",
    "split3_bf16",
    "pack_codebook",
    "pack_samples",
    "split3_codebook",
    "split3_samples",
    "bmu_argmin",
    "bmu_argmin_plain",
    "bmu_argmin_kb",
    "bmu_argmin_kb_plain",
    "bmu_top2",
    "bmu_top2_plain",
    "bmu_split3",
    "bmu_split3_plain",
    "bmu_highest",
    "bmu_highest_plain",
    "highest_envelope",
    "margin_suspects",
    "margin_rescue",
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
# the precision modes the GEMM-form searches serve (the JAX package's six)
GEMM_MODES = ("packed", "bf16", "split2", "split3", "highest", "margin")
# the modes whose operands are one augmented GEMM (K1/K2)
_AUG_MODES = ("packed", "bf16", "split2")


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


def _pad2(t, rows, cols):
    """``t`` (bf16) zero-padded to (rows, cols)."""
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def pack_codebook(w_c, w_sq, mode="packed"):
    """``W_aug`` (K16, XY8) bf16 of mode ``mode`` (``'packed'``, ``'bf16'``
    or ``'split2'``) from the centered (XY, D) f32 codebook and its (XY,)
    ``‖w‖²`` operand. Under ``'split2'`` a ``w_sq`` of None means the
    rounded codebook's own ``¼·Σ wh²``. Columns past XY (padding to a
    multiple of 8, so each row is 16-byte aligned) are zero; the kernels
    never rank them."""
    xy, _ = w_c.shape
    w2t = -2.0 * w_c.float().T
    if mode == "packed":
        wh, wl = split_bf16(w2t)
        rows = [wh, wh, wl]
    elif mode == "bf16":
        rows = [w2t.to(_BF16)]
    elif mode == "split2":
        wh, _ = split_bf16(w2t)
        rows = [wh, wh]
        if w_sq is None:
            # the rounded codebook's norm, summed over d in index order
            sq = torch.square(wh.float())
            w_sq = sq[0].clone()
            for row in sq[1:]:
                w_sq += row
            w_sq = 0.25 * w_sq
    else:
        raise ValueError(f"mode={mode!r}: one augmented GEMM serves {_AUG_MODES}")
    body = torch.cat(rows + list(split3_bf16(w_sq.float().reshape(1, xy))), dim=0)
    return _pad2(body, _round_up(body.shape[0], 16), _round_up(xy, 8))


def pack_samples(x_c, mode="packed"):
    """``A`` (N, K16) bf16 of mode ``mode`` from the centered (N, D) f32
    samples."""
    x_c = x_c.float()
    if mode == "bf16":
        cols = [x_c.to(_BF16)]
    elif mode in ("packed", "split2"):
        xh, xl = split_bf16(x_c)
        cols = [xh, xl, xh] if mode == "packed" else [xh, xl]
    else:
        raise ValueError(f"mode={mode!r}: one augmented GEMM serves {_AUG_MODES}")
    cols.append(torch.ones((x_c.shape[0], 3), dtype=_BF16, device=x_c.device))
    body = torch.cat(cols, dim=1)
    return _pad2(body, x_c.shape[0], _round_up(body.shape[1], 16))


def split3_codebook(w_c):
    """``(wh, wl)`` (D16, XY8) bf16: the split of the centered codebook's
    transpose ``wᵀ`` (not ``-2wᵀ``: K3 applies the −2 after its sum), zero
    past D and XY. Zero rows add exact zeros to every dot."""
    xy, d = w_c.shape
    return tuple(_pad2(t, _round_up(d, 16), _round_up(xy, 8)) for t in split_bf16(w_c.float().T))


def split3_samples(x_c):
    """``(xh, xl)`` (N, D16) bf16: the split of the centered samples."""
    n, d = x_c.shape
    return tuple(_pad2(t, n, _round_up(d, 16)) for t in split_bf16(x_c.float()))


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

# the modes whose operands K1-kb takes (the JAX package's kblock rule)
_KB_MODES = ("packed", "bf16")


def _check_kblock_mode(mode, kblock):
    """The JAX package's refusal of ``kblock`` outside its modes."""
    if kblock is not None and mode not in _KB_MODES:
        raise ValueError("kblock (the K-blocked wide-D candidate) requires mode 'packed' or 'bf16'")


def _check_kblock_depth(kblock):
    if not isinstance(kblock, int) or kblock % 128 or kblock <= 0:
        raise ValueError(f"kblock={kblock} must be a positive multiple of 128")


def _pad_k(a, w_aug, kblock):
    """``A`` and ``W_aug`` with K zero-padded to a multiple of ``kblock``
    (zero columns and rows add exact zeros to every slab)."""
    extra = _round_up(a.shape[1], kblock) - a.shape[1]
    if not extra:
        return a, w_aug
    return (torch.nn.functional.pad(a, (0, extra)),
            torch.nn.functional.pad(w_aug, (0, 0, 0, extra)))


def bmu_argmin_kb_plain(a, w_aug, xy, kblock):
    """Plain K1-kb: K zero-padded to a multiple of ``kblock``, each slab's
    product in fp32 added in slab order into a sum that starts from 0.0
    (the Pallas kernel's ``d_acc += dot(a_k, w_k)``), then the first-index
    argmin."""
    a, w_aug = _pad_k(a, w_aug, kblock)
    d = torch.zeros((a.shape[0], xy), dtype=_F32, device=a.device)
    with fp32_matmul():
        for k0 in range(0, a.shape[1], kblock):
            d += a[:, k0 : k0 + kblock].float() @ w_aug[k0 : k0 + kblock, :xy].float()
    return first_argmin(d)


def bmu_argmin_kb(a, w_aug, xy, kblock):
    """K1-kb: K1's ``(idx, val)`` with the K axis summed in slabs of
    ``kblock`` (a positive multiple of 128; K is zero-padded to a multiple
    of it, as the JAX package pads).

    Source note: replaces ``_kernel_gemm_argmin_kb`` (xpysom_dask_tpu/ops/
    pallas/bmu.py), the K-blocked wide-D candidate, which cut VMEM's
    per-step working set on the TPU. K1's loop over 32-deep staged chunks
    already bounds the working set on the H100, so the kernel is K1's
    template with a second fragment set: each slab accumulates into it,
    then it is added into the running sum with ``__fadd_rn`` and zeroed,
    the Pallas kernel's association. The tensor cores bound it as K1
    (2·N·XY·K operations of the unpadded augmented depth; csrc/
    gemm_bmu.cuh, instance KBLOCKED)."""
    _check_operands(a, w_aug, xy)
    _check_kblock_depth(kblock)
    a, w_aug = _pad_k(a, w_aug, kblock)
    if a.device.type == "cpu":
        return bmu_argmin_kb_plain(a, w_aug, xy, kblock)
    _check_kernel_layout(a, w_aug)
    n = a.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=a.device)
    val = torch.empty(n, dtype=torch.float32, device=a.device)
    rc = build.load_library().xps_bmu_argmin_kb(
        a.data_ptr(), w_aug.data_ptr(), n, a.shape[1], xy, w_aug.shape[1], kblock,
        idx.data_ptr(), val.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(rc, "bmu_argmin_kb")
    bmu_argmin_kb.launches += 1
    return idx, val


bmu_argmin_kb.launches = 0


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


def bmu_split3_plain(xh, xl, wh, wl, w_sq, xy):
    """Plain K3: the three products ``xh·wh``, ``xh·wl``, ``xl·wh`` as fp32
    matmuls of the bf16 values (each product of two bf16 values is exact
    in f32), summed as ``(hh + hl) + lh``, then ``-2·cross + w_sq`` and the
    first-index argmin."""
    xh, xl = xh.float(), xl.float()
    wh, wl = wh[:, :xy].float(), wl[:, :xy].float()
    with fp32_matmul():
        cross = (xh @ wh + xh @ wl) + xl @ wh
    return first_argmin(-2.0 * cross + w_sq[None, :xy])


def bmu_split3(xh, xl, wh, wl, w_sq, xy):
    """K3: ``(idx, val)`` per row, ``idx`` the first-index argmin over the
    first ``xy`` columns of ``-2·((xh·wh + xh·wl) + xl·wh) + w_sq`` and
    ``val`` its f32 value; ``xh, xl`` (N, K) and ``wh, wl`` (K, XY8) bf16,
    ``w_sq`` (XY,) f32.

    Source note: replaces ``_kernel_split3`` (xpysom_dask_tpu/ops/pallas/
    bmu.py, mode 'split3'). Three separate bf16 tensor-core products, each
    accumulated in f32 and summed in the JAX kernel's order, so the mode's
    documented near-tie behaviour is kept (it is not folded into K1's one
    K-chain). On the H100 the tensor cores bound it (3·N·XY·K
    multiply-adds, 5.2e10 per flagship chunk); an instance of K1's kernel
    template with three accumulator sets: WMMA m16n16k16, 64 rows per
    block looping over all codebook tiles, shared-memory staging
    (csrc/bmu.cu)."""
    _check_operands(xh, wh, xy)
    _check_operands(xl, wl, xy)
    if xh.shape != xl.shape or wh.shape != wl.shape:
        raise ValueError(
            f"split pairs differ in shape: {tuple(xh.shape)}/{tuple(xl.shape)} and "
            f"{tuple(wh.shape)}/{tuple(wl.shape)}"
        )
    if w_sq.dtype != _F32 or w_sq.dim() != 1 or w_sq.shape[0] < xy or w_sq.device != xh.device:
        raise ValueError(f"w_sq (XY,) f32 on {xh.device} expected, got {tuple(w_sq.shape)}")
    if xh.device.type == "cpu":
        return bmu_split3_plain(xh, xl, wh, wl, w_sq, xy)
    _check_kernel_layout(xh, wh)
    _check_kernel_layout(xl, wl)
    if not w_sq.is_contiguous():
        raise ValueError("the BMU kernels take contiguous operands")
    n = xh.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=xh.device)
    val = torch.empty(n, dtype=torch.float32, device=xh.device)
    lib = build.load_library()
    rc = lib.xps_bmu_split3(
        xh.data_ptr(), xl.data_ptr(), wh.data_ptr(), wl.data_ptr(), w_sq.data_ptr(),
        n, xh.shape[1], xy, wh.shape[1], idx.data_ptr(), val.data_ptr(),
        torch.cuda.current_stream(xh.device).cuda_stream,
    )
    build.check(rc, "bmu_split3")
    bmu_split3.launches += 1
    return idx, val


bmu_split3.launches = 0


def highest_envelope(d):
    """K4's error bound on ``-2·x·w + w_sq`` per unit of
    ``Σ_d |x_d||2w_d|`` at depth ``d`` (derived in csrc/highest.cu): the
    TF32 split's dropped ``lo·lo`` term and residues, ``3·2⁻²²``, and the
    tensor core's f32 accumulation of the 3d products, ``3·d·2⁻²³``."""
    return 3 * 2.0**-22 + 3 * d * 2.0**-23


def bmu_highest_plain(x, w, w_sq):
    """Plain K4: ``-2·x·wᵀ + ‖w‖²`` with an fp32 matmul (no TF32), then the
    first-index argmin."""
    with fp32_matmul():
        cross = x @ w.T
    return first_argmin(-2.0 * cross + w_sq[None, :])


def _split_tf32(lib, t, stream):
    """K4's operand halves ``(hi, lo)`` of ``t`` (R, D) in the search's
    block layout: blocks of 128 rows x 16 of depth, zero-padded
    (csrc/highest.cu ``xps_split_tf32``)."""
    rows, d = t.shape
    size = -(-rows // 128) * 128 * -(-d // 16) * 16
    hi = torch.empty(size, dtype=_F32, device=t.device)
    lo = torch.empty(size, dtype=_F32, device=t.device)
    build.check(lib.xps_split_tf32(t.data_ptr(), rows, d, hi.data_ptr(), lo.data_ptr(), stream),
                "split_tf32")
    return hi, lo


def bmu_highest(x, w, w_sq):
    """K4: ``(idx, val)`` per row of ``x`` (N, D), ``idx`` the first-index
    argmin over the codebook rows ``w`` (XY, D) of ``-2·x·w + w_sq`` at f32
    accuracy and ``val`` its value.

    Source note: replaces ``_kernel_highest`` (xpysom_dask_tpu/ops/pallas/
    bmu.py, ``Precision.HIGHEST``, a multi-pass bf16 product on the TPU).
    On the H100 the tensor cores bound it: three TF32 passes (``lo·hi +
    hi·lo``, then ``hi·hi`` of the split ``v = hi + lo``), 0.208 ms at the
    flagship chunk at 495 TFLOP/s. csrc/highest.cu splits x and w once per
    call into blocks laid out for ``wgmma``, then runs ``wgmma`` m64n128k8
    from a ring of bulk copies with 128 x 128 block tiles and keeps the
    running argmin in registers; its error envelope,
    ``(3·2⁻²² + 3·D·2⁻²³)·Σ_d|x_d||2w_d|`` (:func:`highest_envelope`), is
    derived there."""
    check_tile_operands(x, w, w_sq)
    if w_sq.shape != (w.shape[0],):
        raise ValueError(f"w_sq (XY,) expected, got {tuple(w_sq.shape)}")
    if x.device.type == "cpu":
        return bmu_highest_plain(x, w, w_sq)
    x, w, w_sq = x.contiguous(), w.contiguous(), w_sq.contiguous()
    (n, d), xy = x.shape, w.shape[0]
    if max(n, d, xy) >= 2**31:
        raise ValueError("operand sizes must fit 32-bit ints")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    val = torch.empty(n, dtype=_F32, device=x.device)
    if n == 0:
        return idx, val
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xh, xl = _split_tf32(lib, x, stream)
    wh, wl = _split_tf32(lib, w, stream)
    rc = lib.xps_bmu_highest(
        xh.data_ptr(), xl.data_ptr(), wh.data_ptr(), wl.data_ptr(), w_sq.data_ptr(), n, d, xy,
        idx.data_ptr(), val.data_ptr(), stream,
    )
    build.check(rc, "bmu_highest")
    bmu_highest.launches += 1
    return idx, val


bmu_highest.launches = 0


def center_by_mean(w_flat):
    """``(c, w − c)``: the codebook mean ``c`` (D,) and the centered f32
    codebook. Subtracting ``c`` from both sides leaves every euclidean and
    norm_p argmin unchanged and shrinks the terms the searches round."""
    w_flat = w_flat.float()
    c = torch.mean(w_flat, dim=0)
    return c, w_flat - c[None, :]


# Margin gate (mode 'margin', as the JAX package's _MARGIN_BOUND): the bf16
# pass's distance error is at most (2u + u² + Kε_f32)·Σ_d|x_d||2w_d| with
# u = 2⁻⁸ (the ‖w‖² operand is an exact 3-term split, so only the cross
# term errs). A winner flip needs err(winner) + err(runner-up) ≥ margin,
# so rows with margin ≤ 2·2.1u·S are ambiguous; 6u is the gate.
MARGIN_BOUND = 6.0 * 2.0**-8
# mode 'margin''s rescue buffer holds this share of a chunk's rows (the JAX
# package's rescue_frac default)
RESCUE_FRAC = 0.125


def margin_suspects(val, val2, x_c, w_c):
    """The rows mode ``'margin'`` re-ranks: top-2 margin ``val2 − val`` at
    most ``MARGIN_BOUND·S`` with ``S = |x_c| @ max_j |2w_c|`` on the
    centered operands."""
    with fp32_matmul():
        s_row = torch.abs(x_c) @ torch.amax(torch.abs(2.0 * w_c), dim=0)
    return (val2 - val) <= MARGIN_BOUND * s_row


def margin_rescue(idx, val, val2, x_c, w_c, w_sq, w_aug, argmin):
    """Exact re-rank of the bf16 top-2 pass's ambiguous rows (mode
    ``'margin'``; the JAX package's ``_margin_rescue``).

    ``idx, val, val2``: K2's winner, its value and the runner-up's value
    on the bf16 operands of the centered samples ``x_c`` (N, D) against
    the centered codebook ``w_c`` (XY, D) with ``‖w‖²`` operand ``w_sq``
    (XY,); ``w_aug`` is the packed ``W_aug`` of the same codebook and
    ``argmin`` K1 or its plain version. The rows of
    :func:`margin_suspects` are compacted in row order (cumsum positions)
    into a buffer of capacity ``max(8, ⌈RESCUE_FRAC·N/8⌉·8)`` (at most N)
    whose unused slots hold the
    out-of-range dump index N — never 0: a zero-filled tail once wrote row
    0's stale winner over its rescue — and re-ranked by packed K1. If the
    buffer would overflow, packed K1 searches every row instead (the one
    host read of the count per call decides). The returned value is
    recomputed in exact f32 for every row: ``(idx, val)``."""
    n, xy = x_c.shape[0], w_c.shape[0]
    if n == 0:
        return idx, val
    suspect = margin_suspects(val, val2, x_c, w_c)
    cap = min(n, max(8, _round_up(int(n * RESCUE_FRAC), 8)))
    if int(torch.count_nonzero(suspect)) > cap:
        idx, _ = argmin(pack_samples(x_c), w_aug, xy)
    else:
        pos = torch.cumsum(suspect.to(torch.int32), 0) - 1
        dest = torch.where(suspect & (pos < cap), pos, cap).long()
        rows = torch.arange(n, device=x_c.device)
        # slot ``cap`` takes every non-suspect row and is dropped
        buf = torch.full((cap + 1,), n, dtype=torch.long, device=x_c.device)
        buf = buf.scatter_(0, dest, rows)[:cap]
        idx_sus, _ = argmin(pack_samples(x_c[torch.clamp(buf, max=n - 1)]), w_aug, xy)
        # the dump index N lands in one extra slot, which is cut off
        idx = torch.cat([idx, idx.new_zeros(1)]).scatter_(0, buf, idx_sus)[:n]
    val = -2.0 * torch.sum(x_c * w_c[idx.long()], dim=1) + w_sq[idx.long()]
    return idx, val


class PackedCodebook:
    """The codebook side of a GEMM-form BMU search in any precision mode
    (K1/K2 for ``'packed'``, ``'bf16'``, ``'split2'``; K3 for ``'split3'``;
    K4 for ``'highest'``; K2 then K1 for ``'margin'``), built once per
    epoch or scoring call and shared by every chunk.

    ``center=True`` subtracts the codebook mean from both sides
    (:func:`center_by_mean`). ``w_sq`` overrides the ``‖w‖²`` operand with
    caller-defined semantics (the JAX package's ``w_sq_raw=True``): cosine
    and the norm_p expansion pass zeros, and ``'split2'`` then splits that
    operand instead of using the rounded codebook's norm."""

    def __init__(self, w_flat, mode="packed", *, center=True, w_sq=None):
        if mode not in GEMM_MODES:
            raise ValueError(f"mode={mode!r}: the GEMM-form searches serve {GEMM_MODES}")
        w_flat = w_flat.float()
        self.xy = w_flat.shape[0]
        self.mode = mode
        self.center, w_c = center_by_mean(w_flat) if center else (None, w_flat)
        raw = None if w_sq is None else w_sq.float().reshape(self.xy).contiguous()
        self.w_sq = torch.sum(w_c * w_c, dim=1) if raw is None else raw
        if mode in _AUG_MODES:
            self.w_aug = pack_codebook(w_c, raw if mode == "split2" else self.w_sq, mode)
        elif mode == "split3":
            self.wh, self.wl = split3_codebook(w_c)
        elif mode == "margin":
            self.w_aug = pack_codebook(w_c, self.w_sq, "bf16")
            self.w_aug_packed = pack_codebook(w_c, self.w_sq, "packed")
            self.w = w_c
        else:
            self.w = w_c.contiguous()

    def _centered(self, x):
        x = x.float()
        return x if self.center is None else x - self.center[None, :]

    def operands(self, x):
        """The arguments of the mode's kernel (and of its plain version)
        for samples ``x`` (N, D): ``(A, W_aug, xy)`` for
        ``bmu_argmin``/``bmu_top2`` (mode ``'margin'``: its bf16 first
        pass), ``(xh, xl, wh, wl, w_sq, xy)`` for ``bmu_split3`` or
        ``(x', w, w_sq)`` for ``bmu_highest``."""
        x = self._centered(x)
        if self.mode in _AUG_MODES:
            return pack_samples(x, self.mode), self.w_aug, self.xy
        if self.mode == "margin":
            return pack_samples(x, "bf16"), self.w_aug, self.xy
        if self.mode == "split3":
            return (*split3_samples(x), self.wh, self.wl, self.w_sq, self.xy)
        return x.contiguous(), self.w, self.w_sq

    def argmin(self, x, use_kernels=True, kblock=None):
        """``(idx, val)``: the mode's kernel, or its plain version when
        ``use_kernels`` is False. ``kblock`` (modes ``'packed'`` and
        ``'bf16'``) sums K in slabs of that depth through K1-kb, the
        counterpart of ``bmu_euclidean(kblock=)``; no training or scoring
        route sets it."""
        _check_kblock_mode(self.mode, kblock)
        if kblock is not None:
            _check_kblock_depth(kblock)
            fn = bmu_argmin_kb if use_kernels else bmu_argmin_kb_plain
            return fn(*self.operands(x), kblock)
        if self.mode == "margin":
            top2 = bmu_top2 if use_kernels else bmu_top2_plain
            idx, val, _, val2 = top2(*self.operands(x))
            return margin_rescue(
                idx, val, val2, self._centered(x), self.w, self.w_sq, self.w_aug_packed,
                bmu_argmin if use_kernels else bmu_argmin_plain,
            )
        if self.mode in _AUG_MODES:
            fn = bmu_argmin if use_kernels else bmu_argmin_plain
        elif self.mode == "split3":
            fn = bmu_split3 if use_kernels else bmu_split3_plain
        else:
            fn = bmu_highest if use_kernels else bmu_highest_plain
        return fn(*self.operands(x))

    def top2(self, x, use_kernels=True, kblock=None):
        """K2's ``(idx, val, idx2, val2)``; modes ``'packed'`` and
        ``'bf16'``, without ``kblock`` (as the JAX package's
        ``top2=True``)."""
        _check_kblock_mode(self.mode, kblock)
        if self.mode not in ("packed", "bf16"):
            raise ValueError("the top-2 search runs in mode 'packed' or 'bf16'")
        if kblock is not None:
            raise ValueError("top2=True does not support kblock")
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
    through K4 (mode ``'highest'``) or the kernel of another mode (every
    mode but ``'margin'``)."""
    return NormPEvenCodebook(w_flat, p, mode).argmin(x, use_kernels)
