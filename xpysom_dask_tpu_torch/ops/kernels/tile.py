"""The shared launcher of the register-tiled exact-f32 engine
``csrc/tile_argmin.cuh`` (the K5–K7 searches in ``elementwise.py``, K8's
matrix in ``manhattan.py``): its operand layout and its plain version, the
codebook segments of a launch, the operand checks, and the first-index
argmin every plain version ends with."""

from __future__ import annotations

import torch

from . import build
from .stats import _sm_count

__all__ = [
    "first_argmin",
    "check_tile_operands",
    "lay_out_f32",
    "lay_out_f32_plain",
    "tile_plan",
    "launch_tile_argmin",
    "launch_tile_store",
]

_F32 = torch.float32

# csrc/tile_argmin.cuh's constants: sample rows per block, codebook rows
# per tile, depth per laid-out chunk
EW_BM = 64
EW_BN = 128
EW_KC = 32


def first_argmin(d):
    """``(idx int32, val)``: the first-index minimum of each row of ``d``."""
    idx = torch.argmin(d, dim=1)
    return idx.to(torch.int32), torch.gather(d, 1, idx[:, None])[:, 0]


def check_tile_operands(x, w, *extra):
    """Validate the (N, D) samples and (XY, D) codebook rows (and any
    (XY,) extras) the register-tiled kernels take."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(
            f"x (N, D) and w (XY, D) expected, got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    if w.shape[0] == 0:
        raise ValueError("empty codebook")
    for t in (x, w, *extra):
        if t.dtype != _F32:
            raise TypeError(f"float32 operands required, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _laid_size(rows, d, trows):
    return -(-rows // trows) * trows * -(-d // EW_KC) * EW_KC


def lay_out_f32_plain(t, trows):
    """Plain version of the engine's layout pre-pass: ``t`` (R, D) f32 as
    the flat array the engine reads, tiles of ``trows`` rows one after the
    other, each as its ``ceil(D / EW_KC)`` chunks of ``EW_KC`` depth, each
    chunk depth-major (the chunk's ``trows`` values at one depth together).
    Zero past R and past D."""
    rows, d = t.shape
    nt, nk = -(-rows // trows), -(-d // EW_KC)
    p = torch.zeros((nt * trows, nk * EW_KC), dtype=_F32, device=t.device)
    p[:rows, :d] = t
    return p.reshape(nt, trows, nk * EW_KC).transpose(1, 2).reshape(-1)


def lay_out_f32(t, trows):
    """The layout pre-pass (csrc/elementwise.cu ``xps_layout_f32``) of
    ``t`` (R, D) f32 with unit column stride; on a CPU tensor its plain
    version."""
    if t.dtype != _F32 or t.dim() != 2:
        raise TypeError(f"an (R, D) float32 operand expected, got {t.dtype} {tuple(t.shape)}")
    if t.device.type == "cpu":
        return lay_out_f32_plain(t, trows)
    rows, d = t.shape
    if t.stride(1) != 1:
        t = t.contiguous()
    out = torch.empty(_laid_size(rows, d, trows), dtype=_F32, device=t.device)
    if rows == 0:
        return out
    rc = build.load_library().xps_layout_f32(
        t.data_ptr(), rows, d, t.stride(0), trows, out.data_ptr(),
        torch.cuda.current_stream(t.device).cuda_stream,
    )
    build.check(rc, "layout_f32")
    return out


def tile_plan(n, xy, sms):
    """``(tiles per segment, segments)`` of a launch over ``n`` samples and
    ``xy`` codebook rows on a card of ``sms`` SMs: the codebook's
    ``EW_BN``-row tiles are cut into equal segments (the last one shorter)
    so that the row blocks times the segments come to about two blocks per
    SM; one segment where the row blocks alone reach that."""
    rb, nt = -(-n // EW_BM), -(-xy // EW_BN)
    want = max(1, min(nt, 65535, (2 * sms + rb // 2) // max(rb, 1)))
    tps = -(-nt // want)
    return tps, -(-nt // tps)


def _check_laid(w_laid, xy, d, device):
    size = _laid_size(xy, d, EW_BN)
    if w_laid.dtype != _F32 or w_laid.shape != (size,) or w_laid.device != device:
        raise ValueError(f"a laid-out codebook of {size} float32 values on {device} expected, "
                         f"got {w_laid.dtype} {tuple(w_laid.shape)} on {w_laid.device}")


def _prepare(x, w, w_laid):
    """The laid-out samples and codebook and the plan of a launch."""
    n, d = x.shape
    xy = w.shape[0]
    if max(n, xy) >= 2**31 or d >= 2**31 - EW_KC:
        raise ValueError("operand sizes must fit 32-bit ints")
    if w_laid is None:
        w_laid = lay_out_f32(w, EW_BN)
    _check_laid(w_laid, xy, d, x.device)
    xl = lay_out_f32(x, EW_BM)
    tps, segs = tile_plan(n, xy, _sm_count(x.device.index or 0))
    return xl, w_laid, tps, segs


def launch_tile_argmin(entry: str, x, w, *args, w_laid=None):
    """Launch the search ``entry`` of the engine (``xps_bmu_manhattan``,
    ``xps_bmu_lp_odd``, ``xps_bmu_lp_frac``): ``entry(x_laid, w_laid, n,
    d, xy, tps, *args, parts, idx, val, stream)``; returns ``(idx, val)``.
    ``w_laid``: the codebook laid out (``lay_out_f32(w, EW_BN)``), or None
    to lay it out here. Raises on a launch error."""
    xl, w_laid, tps, segs = _prepare(x, w, w_laid)
    n, d = x.shape
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    val = torch.empty(n, dtype=_F32, device=x.device)
    parts = torch.empty(2 * segs * n if segs > 1 else 0, dtype=torch.int32, device=x.device)
    fn = getattr(build.load_library(), entry)
    rc = fn(
        xl.data_ptr(), w_laid.data_ptr(), n, d, w.shape[0], tps, *args,
        parts.data_ptr() if segs > 1 else None, idx.data_ptr(), val.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, entry)
    return idx, val


def launch_tile_store(entry: str, x, w):
    """Launch the engine's store ``entry`` (``xps_manhattan_distance``):
    the (N, XY) f32 matrix of the sums. Raises on a launch error."""
    xl, w_laid, tps, _ = _prepare(x, w, None)
    n, d = x.shape
    xy = w.shape[0]
    out = torch.empty((n, xy), dtype=_F32, device=x.device)
    rc = getattr(build.load_library(), entry)(
        xl.data_ptr(), w_laid.data_ptr(), n, d, xy, tps, out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, entry)
    return out
