"""Mini-batch auto-sizing for the PyTorch port.

Counterpart of ``xpysom_dask_tpu/utils/hw.py``. The chunk rules are the
same functions of ``n`` and the budget; the backend is named by the
caller (``'cuda'`` or ``'cpu'``) instead of being asked of JAX.
"""

from __future__ import annotations

import torch

__all__ = [
    "resolve_device",
    "default_n_parallel",
    "round_up",
    "training_chunk",
    "inference_chunk",
]

# Inference chunk-size ladder: geometric rungs (x8) bound the set of
# padded shapes across arbitrary call sizes — see inference_chunk.
INFER_RUNGS = (8, 64, 512)

# Distance-matrix element budget per chunk. 2^24 fp32 elements = 64 MB
# transient on accelerators; scaled down on CPU hosts.
_ACCEL_BUDGET = 1 << 24
_CPU_BUDGET = 1 << 20

# Fused-kernel chunk on CUDA: the flagship chunk that bench.py drives.
# Not measured on the H100 — a neutral default until a port bench tunes it.
_CUDA_FUSED_CHUNK = 16384


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card. A machine
    without a usable card is an error for None, never a quiet fall back to
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is false); "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def training_chunk(n: int, n_parallel: int) -> int:
    """Training chunk size: budget cap, shrunk to the data, floored to a
    multiple of 1024 when above one 1024-row tile. Rounds DOWN so
    ``n_parallel`` (a memory budget) is never exceeded."""
    chunk = min(n_parallel, round_up(max(n, 1), 8))
    if chunk > 1024:
        chunk = max(1024, (chunk // 1024) * 1024)
    return chunk


def inference_chunk(n: int, cap: int) -> tuple[int, int]:
    """Inference chunk sizing: the chunk rounds up to the next
    ``INFER_RUNGS`` rung under the cap (then the cap), and the chunk count
    rounds up to a power of two with fully-masked padding chunks. Returns
    ``(chunk, min_chunks)`` for ``chunk_data``. A cap below 8 stands as
    given: an explicit ``n_parallel`` is never exceeded."""
    if cap > 1024:
        cap = max(1024, (cap // 1024) * 1024)
    elif cap >= 8:
        cap = (cap // 8) * 8
    chunk = next((r for r in INFER_RUNGS if n <= r <= cap), cap)
    c = max(1, -(-n // chunk))
    return chunk, 1 << (c - 1).bit_length()


def default_n_parallel(xy: int, backend: str = "cpu", fused: bool = False) -> int:
    """Samples per chunk, budgeted against the transient ``(chunk, XY)``
    distance matrix and clamped to [256, 65536] in multiples of 256.

    ``fused=True`` on ``'cuda'``: the BMU kernel never materializes the
    distance matrix, so the budget does not apply and the flagship chunk
    is used (not measured on the H100, see ``_CUDA_FUSED_CHUNK``)."""
    if fused and backend == "cuda":
        return _CUDA_FUSED_CHUNK
    budget = _ACCEL_BUDGET if backend == "cuda" else _CPU_BUDGET
    chunk = budget // max(xy, 1)
    chunk = max(256, min(65536, (chunk // 256) * 256))
    return chunk
