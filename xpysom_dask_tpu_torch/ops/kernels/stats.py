"""Per-BMU sufficient-statistics scatter: the K9 wrapper and its plain
PyTorch version.

Counterpart of ``scatter_stats(..., return_acc=True)`` in
``xpysom_dask_tpu/ops/pallas/stats.py``: the fresh (XY, D+1) f32 partial
``acc[b] = Σ_{n: idx_n = b} [x_n | 1]·m_n`` of one chunk. Both versions
add each node's rows in row order starting from 0.0 — the order of the
TPU kernel and of XLA's CPU scatter — so they agree bit for bit, and
neither depends on the run-to-run order of float atomics. Indices outside
``[0, XY)`` contribute nothing, as XLA drops out-of-range scatter updates.
"""

from __future__ import annotations

import functools

import torch

from . import build

__all__ = ["scatter_stats", "scatter_stats_plain", "stats_plan"]


def _augmented(x, m):
    n = x.shape[0]
    ones = torch.ones((n, 1), dtype=torch.float32, device=x.device)
    return torch.cat([x, ones], dim=1) * m[:, None]


def scatter_stats_plain(x, m, idx, xy):
    """Plain K9: an ordered segment sum. Rows are grouped by their rank
    within their node's run (stable sort by node); each group holds at
    most one row per node, so one ``index_add_`` per rank adds a single
    term to each node — the same sequential per-node order on CPU and
    CUDA, without colliding atomics."""
    n, d = x.shape
    acc = torch.zeros((xy, d + 1), dtype=torch.float32, device=x.device)
    keys, order = torch.sort(idx.long(), stable=True)
    keep = (keys >= 0) & (keys < xy)
    keys, order = keys[keep], order[keep]
    if keys.numel() == 0:
        return acc
    aug = _augmented(x.float(), m.float())
    rank = torch.arange(keys.numel(), device=x.device) - torch.searchsorted(keys, keys)
    by_rank = torch.argsort(rank, stable=True)
    start = 0
    for count in torch.bincount(rank).tolist():
        sel = by_rank[start : start + count]
        acc.index_add_(0, keys[sel], aug[order[sel]])
        start += count
    return acc


# csrc/stats.cu's limits: nodes per block (a uint8 node id) and columns
# per pass
MAX_NODES = 128
MAX_COLS = 128


def stats_plan(xy, d, sms):
    """``(nodes, blocks, cols)`` of K9's launch: each of ``blocks`` blocks
    owns ``nodes`` consecutive nodes (the last one fewer), about two blocks
    per SM of a card with ``sms`` SMs; ``cols`` columns of the ``d + 1``
    per pass. csrc/stats.cu sizes its shared memory from ``nodes`` and
    ``cols``."""
    nodes = min(MAX_NODES, max(1, -(-xy // (2 * sms))))
    return nodes, -(-xy // nodes), min(d + 1, MAX_COLS)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def scatter_stats(x, m, idx, xy):
    """K9: the (XY, D+1) partial ``[S | cnt]`` of one chunk.

    Source note: replaces ``_kernel`` of xpysom_dask_tpu/ops/pallas/
    stats.py (which keeps the accumulator in VMEM and read-modify-writes
    one row per sample). On the H100 the bytes bound it (8.6 MB at the
    flagship chunk, 0.0026 ms), and a long run's serial add chain sets a
    floor. One launch, no sort (csrc/stats.cu): each block owns a range of
    nodes (:func:`stats_plan`), scans the indices in row order, groups its
    rows by node with a stable counting sort in shared memory, stages their
    products with the whole block and sums each (node, column) in row
    order from 0.0 — deterministic, atomic-free for floats, and every
    output element written once."""
    if x.dim() != 2 or m.shape != (x.shape[0],) or idx.shape != (x.shape[0],):
        raise ValueError(
            f"x (N, D), m (N,), idx (N,) expected, got {tuple(x.shape)}, "
            f"{tuple(m.shape)}, {tuple(idx.shape)}"
        )
    if x.dtype != torch.float32 or m.dtype != torch.float32:
        raise TypeError(f"float32 x and m required, got {x.dtype} and {m.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"integer idx required, got {idx.dtype}")
    if not (x.device == m.device == idx.device):
        raise ValueError("x, m and idx must share a device")
    if x.device.type == "cpu":
        return scatter_stats_plain(x, m, idx, xy)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, d = x.shape
    if n >= 2**31 or xy * (d + 1) >= 2**31:
        raise ValueError("operands too large for 32-bit kernel indexing")
    if idx.dtype == torch.int64:
        # out-of-range int64 indices must not wrap into range
        idx = torch.where((idx >= 0) & (idx < xy), idx, -1).to(torch.int32)
    x, m, idx = x.contiguous(), m.contiguous(), idx.contiguous()
    nodes, _, _ = stats_plan(xy, d, _sm_count(x.device.index or 0))
    acc = torch.empty((xy, d + 1), dtype=torch.float32, device=x.device)
    rc = build.load_library().xps_scatter_stats(
        x.data_ptr(), m.data_ptr(), idx.data_ptr(), n, d, xy, nodes, acc.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "scatter_stats")
    scatter_stats.launches += 1
    return acc


scatter_stats.launches = 0
