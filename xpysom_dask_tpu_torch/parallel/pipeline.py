"""Out-of-core input pipeline for huge-N training and scoring.

Counterpart of ``xpysom_dask_tpu/parallel/pipeline.py``: stream
*superbatches* from host memory or disk (``np.memmap`` or the native C++
chunk loader) to the card while the previous superbatch computes, folding
the per-BMU sufficient statistics on the device. The batch-SOM update is
a pure reduction over samples, so an epoch is the statistics folded over
the superbatches, then one codebook update. The running statistics are
carried from superbatch to superbatch (``core.make_stats_fn``), so the
chunks' partials are added in the resident epoch's order and
association: with superbatches of whole chunks, streamed training equals
resident training bit for bit.

Feeding the card (:func:`device_superbatches`): each superbatch is
written, padded to whole chunks, into one of two pinned host buffers and
copied to the card on a side stream, so superbatch k + 1 uploads while the
kernels of superbatch k run. The compute stream waits on the copy's
event; the device tensor is marked with ``record_stream`` so its memory is
not reused before the kernels that read it have finished, and a pinned
buffer is refilled only after the copy out of it has finished. On the CPU
the feed is a plain loop.

One process only: the multi-process parts of the JAX pipeline (the
superbatch synchronization across processes and the host gather) are
ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Protocol

import numpy as np
import torch

from ..core import SomSpec, chunk_data, make_stats_fn, make_update_fn
from ..utils.hw import resolve_device, training_chunk
from ..utils.native import load_chunkloader

__all__ = [
    "DataSource",
    "ArraySource",
    "FileSource",
    "IterableSource",
    "ShardedFileSource",
    "device_superbatches",
    "train_streaming",
    "stats_streaming",
    "default_superbatch_rows",
]


class DataSource(Protocol):
    """Anything that can hand out ``(N_i, D)`` float32 superbatches."""

    def __len__(self) -> int: ...

    def superbatches(self, rows: int) -> Iterator[np.ndarray]: ...


def _check_rows(rows: int) -> int:
    """Superbatch size must be positive — 0 would make every source
    yield an immediate empty epoch (the native loader would deliver a
    silent rows==0 EOF; ArraySource's range() would raise a cryptic
    step error), so the contract is enforced once, eagerly, here."""
    rows = int(rows)
    if rows <= 0:
        raise ValueError(f"superbatch rows must be positive, got {rows}")
    return rows


def _process_topology():
    """``(rank, world size)`` of the ``torch.distributed`` process group
    when one is initialized, else ``(0, 1)``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _single_process(what: str) -> None:
    _, world = _process_topology()
    if world > 1:
        raise NotImplementedError(
            f"{what} across {world} processes is not ported to the PyTorch "
            "package yet (ROADMAP Queue 1 item 8)"
        )


class ArraySource:
    """DataSource over an in-memory array or ``np.memmap`` (rows are read
    lazily, so a 25 GB memmap never fully materializes in host RAM)."""

    def __init__(self, array):
        if array.ndim != 2:
            raise ValueError(f"expected (N, D) data, got shape {array.shape}")
        self.array = array

    def __len__(self):
        return self.array.shape[0]

    @property
    def dim(self):
        return self.array.shape[1]

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        for start in range(0, self.array.shape[0], rows):
            yield np.asarray(self.array[start : start + rows], dtype=np.float32)


class IterableSource:
    """DataSource over any re-iterable batch producer — a callable
    returning an iterator of ``(n_i, D)`` arrays per epoch. Adapts external
    input pipelines (datasets, generators) to the streaming trainer;
    batches are re-blocked to the requested superbatch size.

    ``factory`` is called once per epoch, so the producer may reshuffle or
    re-read between epochs.
    """

    def __init__(self, factory, n_rows: int, n_cols: int):
        self.factory = factory
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    def __len__(self):
        return self.n_rows

    @property
    def dim(self):
        return self.n_cols

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        pending = []
        have = 0
        for batch in self.factory():
            batch = np.asarray(batch, dtype=np.float32)
            if batch.ndim != 2 or batch.shape[1] != self.n_cols:
                raise ValueError(
                    f"expected (n, {self.n_cols}) batches, got {batch.shape}"
                )
            pending.append(batch)
            have += batch.shape[0]
            while have >= rows:
                block = np.concatenate(pending) if len(pending) > 1 else pending[0]
                yield block[:rows]
                rest = block[rows:]
                pending = [rest] if rest.shape[0] else []
                have = rest.shape[0]
        if have:
            yield np.concatenate(pending) if len(pending) > 1 else pending[0]


class FileSource:
    """DataSource over a raw binary file of float32 rows, backed by the
    native C++ chunk loader (``csrc/chunkloader.cpp``): a background reader
    thread fills a ring of ``n_buffers`` superbatches so disk I/O overlaps
    device compute. Falls back to ``np.memmap`` slicing when the native
    library is unavailable (no toolchain); ``_lib`` is None then."""

    def __init__(self, path, n_rows: int, n_cols: int, *, n_buffers: int = 3):
        self.path = str(path)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.n_buffers = int(n_buffers)
        self._lib = load_chunkloader()

    def __len__(self):
        return self.n_rows

    @property
    def dim(self):
        return self.n_cols

    def _superbatches_native(self, rows: int) -> Iterator[np.ndarray]:
        import ctypes

        lib = self._lib
        h = lib.xs_open(self.path.encode(), self.n_rows, self.n_cols, rows, self.n_buffers)
        if not h:
            raise OSError(f"native loader failed to open {self.path}")
        try:
            while True:
                got = ctypes.c_int64(0)
                ptr = lib.xs_acquire(h, ctypes.byref(got))
                if got.value < 0:
                    detail = (lib.xs_error(h) or b"").decode(errors="replace")
                    raise OSError(f"native loader: {detail or f'read error on {self.path}'}")
                if got.value == 0:
                    break
                # copy out of the ring buffer: the view dies at release
                block = np.ctypeslib.as_array(ptr, shape=(got.value, self.n_cols)).copy()
                lib.xs_release(h)
                yield block
        finally:
            lib.xs_close(h)

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        rows = _check_rows(rows)
        if self._lib is not None:
            yield from self._superbatches_native(rows)
            return
        mm = np.memmap(self.path, dtype=np.float32, mode="r", shape=(self.n_rows, self.n_cols))
        yield from ArraySource(mm).superbatches(rows)


class ShardedFileSource:
    """DataSource over MANY raw float32 shard files: each process streams
    only its round-robin slice of the file list
    (``files[process_id::num_processes]``), so processes of one run read
    disjoint data straight from storage.

    Shard row counts are inferred from file sizes (must be whole float32
    rows of ``n_cols``). Each shard streams through :class:`FileSource`,
    and blocks are re-joined across shard boundaries so superbatches keep
    the requested size.

    ``process_id``/``num_processes`` default to the ``torch.distributed``
    rank and world size when a process group is initialized, else 0 and
    1; pass them explicitly for testing or external launchers. (Training
    across processes is ROADMAP Queue 1 item 8.)"""

    def __init__(self, files, n_cols: int, *, process_id=None, num_processes=None,
                 n_buffers: int = 3):
        files = [str(f) for f in files]
        if not files:
            raise ValueError("ShardedFileSource needs at least one file")
        rank, world = _process_topology()
        process_id = rank if process_id is None else int(process_id)
        num_processes = world if num_processes is None else int(num_processes)
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for {num_processes} processes"
            )
        self.n_cols = int(n_cols)
        self.files = files[process_id::num_processes]
        self._sources = []
        row_bytes = 4 * self.n_cols
        for f in self.files:
            size = os.path.getsize(f)
            if size % row_bytes:
                raise ValueError(
                    f"{f}: {size} bytes is not a whole number of "
                    f"float32 rows of {self.n_cols} columns"
                )
            self._sources.append(FileSource(f, size // row_bytes, self.n_cols,
                                            n_buffers=n_buffers))

    def __len__(self):
        return sum(len(s) for s in self._sources)

    @property
    def dim(self):
        return self.n_cols

    def superbatches(self, rows: int) -> Iterator[np.ndarray]:
        if not self._sources:  # more processes than shards: empty shard
            return

        def gen():
            for s in self._sources:
                yield from s.superbatches(rows)

        # re-block across shard boundaries so every superbatch (except the
        # tail) is exactly `rows` tall
        yield from IterableSource(gen, len(self), self.n_cols).superbatches(rows)


def default_superbatch_rows(d: int) -> int:
    """~256 MB device-resident superbatch block, scaled by feature width
    and clamped to [4096, 2^22] rows — the one sizing rule of the
    streaming paths (training and inference)."""
    return max(4096, min(1 << 22, (1 << 28) // (4 * max(int(d), 1))))


def device_superbatches(source: DataSource, rows: int, chunk: int, device):
    """Yield each superbatch of ``source`` on ``device`` as ``(chunks,
    mask, n)``: ``core.chunk_data``'s (C, chunk, D) chunks, zero-padded to
    whole chunks, its (C, chunk) float32 mask and the row count. On the
    card through pinned buffers and a side copy stream (module
    docstring); the tensors are ready for work enqueued on the current
    stream."""
    rows = _check_rows(rows)
    device = torch.device(device)
    if device.type != "cuda":
        for block in source.superbatches(rows):
            chunks, mask, n = chunk_data(np.atleast_2d(np.asarray(block, np.float32)), chunk)
            yield torch.from_numpy(chunks).to(device), torch.from_numpy(mask).to(device), n
        return
    compute = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    buffers = [None, None]  # per slot: (pinned rows, event of the copy out of it)
    for k, block in enumerate(source.superbatches(rows)):
        block = np.atleast_2d(np.asarray(block, np.float32))
        n, d = block.shape
        c = max(1, -(-n // chunk))
        total = c * chunk
        slot = buffers[k % 2]
        if slot is not None and slot[0].shape[0] >= total and slot[0].shape[1] == d:
            pinned = slot[0]
            slot[1].synchronize()  # the copy out of this buffer has finished
        else:
            pinned = torch.empty((max(total, -(-rows // chunk) * chunk), d),
                                 dtype=torch.float32, pin_memory=True)
        host = pinned.numpy()
        host[:n] = block
        host[n:total] = 0.0
        with torch.cuda.stream(copy):
            chunks = pinned[:total].to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        # the caching allocator must not hand this memory to the next
        # superbatch's copy before the compute stream's kernels have read it
        chunks.record_stream(compute)
        compute.wait_event(done)
        buffers[k % 2] = (pinned, done)
        mask = (torch.arange(total, device=device) < n).to(torch.float32)
        yield chunks.view(c, chunk, d), mask.view(c, chunk), n


def stats_streaming(spec: SomSpec, w, source: DataSource, chunk: int, superbatch_rows: int,
                    stats_fn=None):
    """One epoch's sufficient statistics ``[S | cnt]`` ((XY, D+1) f32 on
    ``w``'s device) folded over streamed superbatches, the running total
    carried through ``stats_fn`` (default ``core.make_stats_fn(spec)``).
    ``w`` is the (X, Y, D) codebook on its device."""
    _single_process("streaming statistics")
    if stats_fn is None:
        stats_fn = make_stats_fn(spec)
    acc = None
    for chunks, mask, _ in device_superbatches(source, superbatch_rows, chunk, w.device):
        if chunks.shape[-1] != spec.input_len:
            raise ValueError(
                f"Received {chunks.shape[-1]} features, expected {spec.input_len}."
            )
        acc = stats_fn(w, chunks, mask, acc)
    if acc is None:
        raise ValueError("empty data source")
    return acc


def train_streaming(
    spec: SomSpec,
    weights: np.ndarray,
    source: DataSource,
    num_epochs: int,
    *,
    iter_beg: int = 0,
    iter_end: Optional[int] = None,
    chunk: int = 8192,
    superbatch_rows: Optional[int] = None,
    device=None,
    progress=None,
) -> np.ndarray:
    """Full streamed training: per epoch, fold the statistics over the
    superbatches, then apply one codebook update (the semantics of the
    resident path). Returns the (X, Y, D) float32 codebook on the host.

    ``device`` defaults to the card (``RuntimeError`` without one; pass
    ``'cpu'`` for the CPU). ``superbatch_rows`` defaults to a ~256 MB block
    (:func:`default_superbatch_rows`); ``chunk`` is aligned as the resident
    path aligns it (``utils.hw.training_chunk``), so a superbatch that is
    a multiple of the chunk gives the resident path's chunks and its bits.
    ``progress(t)`` is called after each epoch ``t``."""
    _single_process("streaming training")
    if iter_end is None:
        iter_end = num_epochs
    if superbatch_rows is None:
        superbatch_rows = default_superbatch_rows(getattr(source, "dim", spec.input_len))
    superbatch_rows = _check_rows(superbatch_rows)
    chunk = training_chunk(superbatch_rows, chunk)
    stats_fn = make_stats_fn(spec)
    update_fn = make_update_fn(spec, num_epochs)
    host = np.ascontiguousarray(weights, dtype=np.float32)
    w = torch.from_numpy(host).to(resolve_device(device))
    for t in range(iter_beg, iter_end):
        acc = stats_streaming(spec, w, source, chunk, superbatch_rows, stats_fn=stats_fn)
        w = update_fn(w, acc, t)
        if progress is not None:
            progress(t)
    return w.cpu().numpy()
