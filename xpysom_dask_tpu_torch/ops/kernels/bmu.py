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

The kernels: K1 ``bmu_argmin`` replaces ``_kernel_gemm_argmin``, K3
``bmu_split3`` ``_kernel_split3``, K2 ``bmu_top2`` ``_kernel_gemm_top2``
(K1's search with a top-2 finish) and K1-kb ``bmu_argmin_kb``
``_kernel_gemm_argmin_kb`` (K1 with K summed slab by slab, reached
through ``PackedCodebook.argmin(kblock=)``): four variants of one wgmma
search, ``csrc/gemm_sm90.cu``, which reads its operands laid out by
:func:`lay_out` (``PackedCodebook`` lays its codebook out once and packs
and lays out each chunk's samples in one pass). K4 ``bmu_highest``
replaces ``_kernel_highest`` (``csrc/highest.cu``). On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises.
"""

from __future__ import annotations

import functools
import os
import warnings

import torch

from ..distances import fp32_matmul
from . import build
from .tile import check_tile_operands, first_argmin

__all__ = [
    "env_mode",
    "split_bf16",
    "split3_bf16",
    "pack_codebook",
    "pack_samples",
    "split3_codebook",
    "split3_samples",
    "lay_out",
    "lay_out_plain",
    "lay_out_samples",
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


def env_mode(default="packed") -> str:
    """``XPYSOM_BMU_PRECISION``, read at spec construction only (the JAX
    package's ``_env_mode``): an unrecognized value warns and falls back
    to ``default``, so a stale env var does not break every constructor
    (an explicit ``bmu_precision=`` raises instead)."""
    m = os.environ.get("XPYSOM_BMU_PRECISION", "").lower()
    if m in GEMM_MODES:
        return m
    if m:
        warnings.warn(
            f"XPYSOM_BMU_PRECISION={m!r} not recognized "
            f"(expected packed|split2|split3|highest|bf16|margin); "
            f"using {default!r}"
        )
    return default


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


# The wgmma searches' operand layout (csrc/gemm_sm90.cu, whose constants
# these repeat): tiles of GEMM_BM sample rows or of the codebook tile width
# (K1_BN, K3_BN), each cut along K into chunks of GEMM_BK, each chunk
# contiguous in wgmma's canonical no-swizzle K-major layout; K3 keeps a row
# tile's A resident in shared memory up to RESIDENT_K of depth.
GEMM_BM = 128
GEMM_BK = 64
K1_BN = 128
K3_BN = 64
RESIDENT_K = 256


def lay_out_plain(t, trows):
    """Plain version of the layout pre-pass: ``t`` (R, K) bf16 as the flat
    ``ceil(R/trows)·trows × K16`` array the wgmma searches read (K16 = K
    rounded up to 16). Each tile of ``trows`` rows holds its K chunks of
    depth ``dc = min(GEMM_BK, K16 − c·GEMM_BK)`` one after the other; a
    chunk holds its 8-row groups one after the other, a group its ``dc/8``
    core matrices (8 rows × 8 values) along K, a core matrix its 8 rows of
    8 values. Zero past R and past K."""
    rows, k = t.shape
    k16 = _round_up(k, 16)
    ntiles = -(-rows // trows)
    p = _pad2(t, ntiles * trows, k16).reshape(ntiles, trows, k16)
    parts = []
    for c0 in range(0, k16, GEMM_BK):
        dc = min(GEMM_BK, k16 - c0)
        blk = p[:, :, c0 : c0 + dc].reshape(ntiles, trows // 8, 8, dc // 8, 8)
        parts.append(blk.permute(0, 1, 3, 2, 4).reshape(ntiles, trows * dc))
    return torch.cat(parts, dim=1).reshape(-1)


def lay_out(t, trows):
    """The layout pre-pass (csrc/gemm_sm90.cu ``xps_layout_bf16``) of ``t``
    (R, K) bf16, any strides; on a CPU tensor its plain version."""
    if t.dtype != _BF16 or t.dim() != 2:
        raise TypeError(f"an (R, K) bf16 operand expected, got {t.dtype} {tuple(t.shape)}")
    if t.device.type == "cpu":
        return lay_out_plain(t, trows)
    rows, k = t.shape
    k16 = _round_up(k, 16)
    out = torch.empty(-(-rows // trows) * trows * k16, dtype=_BF16, device=t.device)
    rc = build.load_library().xps_layout_bf16(
        t.data_ptr(), rows, k, t.stride(0), t.stride(1), trows, k16, out.data_ptr(),
        torch.cuda.current_stream(t.device).cuda_stream,
    )
    build.check(rc, "layout_bf16")
    return out


# the sample operands' segments of each mode: the high (0) or low (1) bf16
# half of x_c per D-wide segment, and the count of trailing ones columns
# (pack_samples, split3_samples)
_SAMPLE_SEGMENTS = {
    "packed": ((0, 1, 0), 3), "bf16": ((0,), 3), "split2": ((0, 1), 3),
    "split3_hi": ((0,), 0), "split3_lo": ((1,), 0),
}


def _sample_operand_plain(x_c, part):
    if part.startswith("split3"):
        return split3_samples(x_c)[part == "split3_lo"]
    return pack_samples(x_c, part)


def lay_out_samples(x, center, part):
    """The samples' operand of mode ``part`` (``'packed'``, ``'bf16'``,
    ``'split2'``, or ``'split3_hi'`` / ``'split3_lo'``) for ``x`` (N, D) f32
    centered by ``center`` (D,) (None: as given), laid out for the wgmma
    searches in GEMM_BM-row tiles: ``lay_out(pack_samples(x − center,
    part), GEMM_BM)`` (or of ``split3_samples``' half), which is its plain
    version, in one pass (csrc/gemm_sm90.cu ``xps_pack_layout``) on the
    card."""
    x = x.float()
    if x.device.type == "cpu":
        x_c = x if center is None else x - center[None, :]
        return lay_out_plain(_sample_operand_plain(x_c, part), GEMM_BM)
    segs, ones = _SAMPLE_SEGMENTS[part]
    n, d = x.shape
    if x.stride(1) != 1:
        x = x.contiguous()
    k16 = _round_up(len(segs) * d + ones, 16)
    out = torch.empty(-(-n // GEMM_BM) * GEMM_BM * k16, dtype=_BF16, device=x.device)
    if n == 0:
        return out
    if center is not None:
        center = center.float().contiguous()
    rc = build.load_library().xps_pack_layout(
        x.data_ptr(), x.stride(0), None if center is None else center.data_ptr(), n, d,
        len(segs), sum(lo << i for i, lo in enumerate(segs)), ones, k16, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "pack_layout")
    return out


def _codebook_rows(w_t, xy):
    """The (XY, K) rows of a (K, XY8) codebook operand (a transposed view)."""
    return w_t[:, :xy].T


def _check_laid(w_laid, xy, k, trows, device):
    size = -(-xy // trows) * trows * _round_up(k, 16)
    if w_laid.dtype != _BF16 or w_laid.shape != (size,) or w_laid.device != device:
        raise ValueError(f"a laid-out codebook of {size} bf16 values on {device} expected, got "
                         f"{w_laid.dtype} {tuple(w_laid.shape)} on {w_laid.device}")


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


def _empty_result(device):
    return (torch.empty(0, dtype=torch.int32, device=device),
            torch.empty(0, dtype=_F32, device=device))


def _gemm_sm90(entry, operands, n, k, xy, *ints, outs=2):
    """Launch a search of csrc/gemm_sm90.cu on laid-out operands: K1
    (``xps_gemm_argmin``), K3 (``xps_gemm_split3``), K2 (``xps_gemm_top2``)
    or K1-kb (``xps_gemm_argmin_kb``). ``operands``: the tensors whose
    pointers lead the call (the sample halves, the codebook halves, K3's
    ``w_sq``); ``ints``: the entry's trailing int arguments (K1, K3:
    ``resident``, which keeps each block's A in shared memory up to
    RESIDENT_K of depth; K1-kb: ``kblock``). Returns ``(idx, val)``, or
    with ``outs=4`` K2's ``(idx, val, idx2, val2)``."""
    dev = operands[0].device
    out = [torch.empty(n, dtype=(torch.int32, _F32)[i % 2], device=dev) for i in range(outs)]
    rc = getattr(build.load_library(), entry)(
        *(t.data_ptr() for t in operands), n, _round_up(k, 16), xy, *map(int, ints),
        *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, entry)
    return tuple(out)


def _codebook_laid(w_aug, xy, k, device, w_laid):
    """K1's codebook operand laid out (``w_laid``, checked, or laid out
    here): what K1, K2 and K1-kb read."""
    if w_laid is None:
        w_laid = lay_out(_codebook_rows(w_aug, xy), K1_BN)
    _check_laid(w_laid, xy, k, K1_BN, device)
    return w_laid


def bmu_argmin(a, w_aug, xy, w_laid=None):
    """K1: ``(idx, val)`` per row, ``idx`` the first-index argmin over the
    first ``xy`` columns of ``A @ W_aug`` and ``val`` its f32 value.
    ``w_laid``: the codebook already laid out (``lay_out(W_aug[:, :xy].T,
    K1_BN)``, which ``PackedCodebook`` makes once); without it the call
    lays it out.

    Source note: replaces ``_kernel_gemm_argmin`` (xpysom_dask_tpu/ops/
    pallas/bmu.py). On the H100 the tensor cores bound it (1.1e11 bf16
    operations per flagship chunk, 0.113 ms). csrc/gemm_sm90.cu: a pre-pass lays A and W_aug out in wgmma's
    canonical layout, one producer thread streams both through a 4-stage
    ring of bulk copies on mbarriers, two consumer warpgroups run wgmma
    m64n128k16, and the argmin is finished in the accumulator registers."""
    _check_operands(a, w_aug, xy)
    if a.device.type == "cpu":
        return bmu_argmin_plain(a, w_aug, xy)
    _check_kernel_layout(a, w_aug)
    n, k = a.shape
    w_laid = _codebook_laid(w_aug, xy, k, a.device, w_laid)
    return _launch_k1(lay_out(a, GEMM_BM), w_laid, n, k, xy)


def _launch_k1(a_laid, w_laid, n, k, xy):
    """K1 on laid-out operands, counted on ``bmu_argmin``."""
    if n == 0:
        return _empty_result(a_laid.device)
    # K1 streams its A (measured faster than keeping it resident)
    out = _gemm_sm90("xps_gemm_argmin", (a_laid, w_laid), n, k, xy, False)
    bmu_argmin.launches += 1
    return out


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


def bmu_argmin_kb(a, w_aug, xy, kblock, w_laid=None):
    """K1-kb: K1's ``(idx, val)`` with the K axis summed in slabs of
    ``kblock`` (a positive multiple of 128), the JAX package's K-blocked
    association. ``w_laid`` as for :func:`bmu_argmin`.

    Source note: replaces ``_kernel_gemm_argmin_kb`` (xpysom_dask_tpu/ops/
    pallas/bmu.py), the K-blocked wide-D candidate, which cut VMEM's
    per-step working set on the TPU. K1's ring of 64-deep stages already
    bounds the working set on the H100, so the kernel is K1's wgmma
    search (csrc/gemm_sm90.cu, variant KBLOCKED) whose slabs close in the
    consumers' loop: each slab runs into a fresh accumulator set, added
    into a running f32 sum with ``__fadd_rn``, the Pallas kernel's
    association. K is not padded to ``kblock`` on the card (the last slab
    closes at K's end; zero depth adds exact zeros, so the values are
    those of the padded operands); the plain version pads, as the JAX
    package does. The tensor cores bound it as K1 (2·N·XY·K operations of
    the unpadded augmented depth)."""
    _check_operands(a, w_aug, xy)
    _check_kblock_depth(kblock)
    if a.device.type == "cpu":
        return bmu_argmin_kb_plain(a, w_aug, xy, kblock)
    _check_kernel_layout(a, w_aug)
    n, k = a.shape
    w_laid = _codebook_laid(w_aug, xy, k, a.device, w_laid)
    return _launch_kb(lay_out(a, GEMM_BM), w_laid, n, k, xy, kblock)


def _launch_kb(a_laid, w_laid, n, k, xy, kblock):
    """K1-kb on laid-out operands, counted on ``bmu_argmin_kb``."""
    if n == 0:
        return _empty_result(a_laid.device)
    out = _gemm_sm90("xps_gemm_argmin_kb", (a_laid, w_laid), n, k, xy, kblock)
    bmu_argmin_kb.launches += 1
    return out


bmu_argmin_kb.launches = 0


def bmu_top2(a, w_aug, xy, w_laid=None):
    """K2: ``(idx, val, idx2, val2)`` — the two best columns per row in
    stable-argsort order (value, then lowest index; a duplicate minimum is
    the runner-up with ``val2 == val``). ``w_laid`` as for
    :func:`bmu_argmin`.

    Source note: replaces ``_kernel_gemm_top2`` (xpysom_dask_tpu/ops/
    pallas/bmu.py). K1's wgmma search (csrc/gemm_sm90.cu, variant TOP2) on
    the same laid-out operands and bound, with a top-2 finish in
    registers: each thread keeps two (value, index) places over its
    columns, the quad and the running pair merge lexicographically. Its
    first place is K1's bit for bit."""
    _check_operands(a, w_aug, xy)
    if a.device.type == "cpu":
        return bmu_top2_plain(a, w_aug, xy)
    _check_kernel_layout(a, w_aug)
    n, k = a.shape
    w_laid = _codebook_laid(w_aug, xy, k, a.device, w_laid)
    return _launch_k2(lay_out(a, GEMM_BM), w_laid, n, k, xy)


def _launch_k2(a_laid, w_laid, n, k, xy):
    """K2 on laid-out operands, counted on ``bmu_top2``."""
    if n == 0:
        return (*_empty_result(a_laid.device), *_empty_result(a_laid.device))
    out = _gemm_sm90("xps_gemm_top2", (a_laid, w_laid), n, k, xy, outs=4)
    bmu_top2.launches += 1
    return out


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


def bmu_split3(xh, xl, wh, wl, w_sq, xy, w_laid=None):
    """K3: ``(idx, val)`` per row, ``idx`` the first-index argmin over the
    first ``xy`` columns of ``-2·((xh·wh + xh·wl) + xl·wh) + w_sq`` and
    ``val`` its f32 value; ``xh, xl`` (N, K) and ``wh, wl`` (K, XY8) bf16,
    ``w_sq`` (XY,) f32. ``w_laid``: ``(wh, wl)`` already laid out
    (``lay_out(w[:, :xy].T, K3_BN)`` each, made once by
    ``PackedCodebook``); without it the call lays them out.

    Source note: replaces ``_kernel_split3`` (xpysom_dask_tpu/ops/pallas/
    bmu.py, mode 'split3'). Three separate bf16 tensor-core products, each
    accumulated in f32 and summed in the JAX kernel's order, so the mode's
    documented near-tie behaviour is kept (it is not folded into K1's one
    K-chain). On the H100 the tensor cores bound it (3·2·N·XY·K bf16
    operations, 0.104 ms per flagship chunk). K1's pipeline
    (csrc/gemm_sm90.cu) with three accumulator sets of wgmma m64n64k16;
    the samples' halves stay resident in shared memory up to RESIDENT_K."""
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
    n, k = xh.shape
    if w_laid is None:
        w_laid = tuple(lay_out(_codebook_rows(t, xy), K3_BN) for t in (wh, wl))
    for t in w_laid:
        _check_laid(t, xy, k, K3_BN, xh.device)
    return _launch_k3((lay_out(xh, GEMM_BM), lay_out(xl, GEMM_BM)), w_laid, n, k, xy, w_sq)


def _launch_k3(x_laid, w_laid, n, k, xy, w_sq):
    """K3 on laid-out operands, counted on ``bmu_split3``."""
    if n == 0:
        return _empty_result(w_sq.device)
    out = _gemm_sm90("xps_gemm_split3", (*x_laid, *w_laid, w_sq), n, k, xy,
                     _round_up(k, 16) <= RESIDENT_K)
    bmu_split3.launches += 1
    return out


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


def _centered_codebook(w_flat, center):
    """``(c, w − c)`` for ``center`` True (the codebook's own mean,
    :func:`center_by_mean`) or a given (D,) centre; ``(None, w)`` for
    False or None."""
    if center is None or center is False:
        return None, w_flat
    if center is True:
        return center_by_mean(w_flat)
    c = center.float()
    return c, w_flat - c[None, :]


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
    (:func:`center_by_mean`); a (D,) tensor subtracts that centre instead
    (a codebook shard takes the full codebook's mean, so that its values
    are the full search's, comparable across shards); False none.
    ``w_sq`` overrides the ``‖w‖²`` operand with caller-defined semantics
    (the JAX package's ``w_sq_raw=True``): cosine and the norm_p
    expansion pass zeros, and ``'split2'`` then splits that
    operand instead of using the rounded codebook's norm. On the card the
    wgmma searches (K1, K2, K1-kb, K3) read the codebook laid out once per
    object (:meth:`laid`) and the samples packed and laid out in one
    pass."""

    def __init__(self, w_flat, mode="packed", *, center=True, w_sq=None):
        if mode not in GEMM_MODES:
            raise ValueError(f"mode={mode!r}: the GEMM-form searches serve {GEMM_MODES}")
        w_flat = w_flat.float()
        self.xy = w_flat.shape[0]
        self.mode = mode
        self.center, w_c = _centered_codebook(w_flat, center)
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
        self._laid = None

    def laid(self):
        """The codebook operands of the wgmma searches laid out once for
        this codebook (:func:`lay_out`), a tuple: K1's ``W_aug`` (K1, K2
        and K1-kb read it; under ``'margin'`` the packed re-rank's, then
        the bf16 ``W_aug`` of K2's first pass); K3's ``wh`` and ``wl``."""
        if self._laid is None:
            if self.mode == "split3":
                src = [(self.wh, K3_BN), (self.wl, K3_BN)]
            elif self.mode == "margin":
                src = [(self.w_aug_packed, K1_BN), (self.w_aug, K1_BN)]
            else:
                src = [(self.w_aug, K1_BN)]
            self._laid = tuple(lay_out(_codebook_rows(t, self.xy), tr) for t, tr in src)
        return self._laid

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
        # the kernels run on the card, with the codebook laid out once
        on_card = use_kernels and self.w_sq.device.type == "cuda"
        if kblock is not None:
            _check_kblock_depth(kblock)
            if on_card:
                return self._on_card(_launch_kb, x, self.mode, self.laid()[0], kblock)
            fn = bmu_argmin_kb if use_kernels else bmu_argmin_kb_plain
            return fn(*self.operands(x), kblock)
        if self.mode == "margin":
            if on_card:
                idx, val, _, val2 = self._on_card(_launch_k2, x, "bf16", self.laid()[1])
                argmin = functools.partial(bmu_argmin, w_laid=self.laid()[0])
            else:
                top2 = bmu_top2 if use_kernels else bmu_top2_plain
                idx, val, _, val2 = top2(*self.operands(x))
                argmin = bmu_argmin if use_kernels else bmu_argmin_plain
            return margin_rescue(
                idx, val, val2, self._centered(x), self.w, self.w_sq, self.w_aug_packed, argmin)
        if on_card and self.mode in _AUG_MODES:
            return self._on_card(_launch_k1, x, self.mode, self.laid()[0])
        if on_card and self.mode == "split3":
            return self._on_card(_launch_k3, x, "split3_hi", self.laid(), self.w_sq)
        if self.mode in _AUG_MODES:
            fn = bmu_argmin if use_kernels else bmu_argmin_plain
        elif self.mode == "split3":
            fn = bmu_split3 if use_kernels else bmu_split3_plain
        else:
            fn = bmu_highest if use_kernels else bmu_highest_plain
        return fn(*self.operands(x))

    def _on_card(self, launch, x, part, w_laid, *extra):
        """``launch(A, w_laid, N, K, XY, *extra)``: a wgmma search on the
        card, ``A`` the samples of :meth:`operands` packed as ``part`` and
        laid out in one pass (:func:`lay_out_samples`; under ``'split3'``
        both halves), bit for bit, without their intermediate copies."""
        n, d = x.shape
        if max(n, d, self.xy) >= 2**31:
            raise ValueError("operand sizes must fit 32-bit ints")
        if self.mode == "split3":
            a = tuple(lay_out_samples(x, self.center, p) for p in ("split3_hi", "split3_lo"))
        else:
            a = lay_out_samples(x, self.center, part)
        segs, ones = _SAMPLE_SEGMENTS[part]
        return launch(a, w_laid, n, len(segs) * d + ones, self.xy, *extra)

    def top2(self, x, use_kernels=True, kblock=None):
        """K2's ``(idx, val, idx2, val2)``; modes ``'packed'`` and
        ``'bf16'``, without ``kblock`` (as the JAX package's
        ``top2=True``)."""
        _check_kblock_mode(self.mode, kblock)
        if self.mode not in ("packed", "bf16"):
            raise ValueError("the top-2 search runs in mode 'packed' or 'bf16'")
        if kblock is not None:
            raise ValueError("top2=True does not support kblock")
        if use_kernels and self.w_sq.device.type == "cuda":
            return self._on_card(_launch_k2, x, self.mode, self.laid()[0])
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
    the default mode is ``'highest'``. ``center`` (a (D,) tensor) replaces
    the codebook's own mean, as :class:`PackedCodebook`'s does."""

    def __init__(self, w_flat, p=2, mode="highest", center=True):
        if not float(p).is_integer() or int(p) % 2 != 0 or int(p) < 2:
            raise ValueError("p must be even and >= 2")
        if mode == "margin":
            raise ValueError(
                "mode='margin' is not supported for the norm_p expansion; "
                "use 'highest' (the default)"
            )
        self.p = int(p)
        self.center, wc = _centered_codebook(w_flat.float(), center)
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
