"""The shared launcher of the register-tiled exact-f32 BMU searches built on
``csrc/tile_argmin.cuh`` (K5–K7 in ``elementwise.py``),
their operand checks, and the first-index argmin every plain version ends
with."""

from __future__ import annotations

import torch

from . import build

__all__ = ["first_argmin", "check_tile_operands", "launch_tile_argmin"]

_F32 = torch.float32


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


def launch_tile_argmin(entry: str, x, w, *args, operands=()):
    """Launch the C entry point ``entry`` of a ``tile_argmin.cuh`` kernel:
    ``entry(x, w, *operands, n, d, xy, *args, idx, val, stream)``; returns
    ``(idx, val)``. Raises on a layout the kernels do not take and on a
    launch error."""
    tensors = (x, w, *operands)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the tile kernels take contiguous operands")
    n, d = x.shape
    xy = w.shape[0]
    if max(n, d, xy) >= 2**31:
        raise ValueError("operand sizes must fit 32-bit ints")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    val = torch.empty(n, dtype=_F32, device=x.device)
    fn = getattr(build.load_library(), entry)
    rc = fn(
        *(t.data_ptr() for t in tensors), n, d, xy, *args, idx.data_ptr(), val.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, entry)
    return idx, val
