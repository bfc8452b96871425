"""Tracing / profiling hooks (counterpart of
``xpysom_dask_tpu/utils/profiling.py``):

- ``trace(dir)``: context manager around ``torch.profiler`` writing a
  TensorBoard-viewable trace (CPU, and the card where there is one) of
  whatever runs inside (e.g. a training call);
- ``annotate(name, **counts)``: a named span of the program (``xpysom.``
  names on the API path), a no-op while no ``torch.profiler`` runs; under
  one it is a ``record_function`` span on the trace's timeline and a
  record kept in memory with its counts (``recorded()``);
- ``EpochTimer``: lightweight host-side per-epoch wall-clock collector
  (mean/std/last), usable as the ``progress`` callback of the streaming
  pipeline;
- ``epoch_anatomy``: slope-decontaminated decomposition of one training
  epoch into BMU / scatter / update stage costs.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time

import torch

__all__ = ["trace", "annotate", "recorded", "EpochTimer", "epoch_anatomy"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture a profile into ``log_dir`` (TensorBoard format); yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


class _Buffer:
    """The last ``capacity`` span records, the oldest dropped first, and
    how many were dropped."""

    def __init__(self, capacity: int):
        self.records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.lock = threading.Lock()

    def append(self, record: dict) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


CAPACITY = 65536
_BUFFER = _Buffer(CAPACITY)
_IDS = itertools.count(1)
_OPEN = threading.local()  # the ids of each thread's open spans


class _Off:
    """What ``annotate`` gives while no profiler runs: nothing recorded,
    counts ignored."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    """One span under a running profiler: a ``record_function`` on the
    trace's timeline and a record in the buffer (``id``, ``name``, ``t0``
    and ``t1`` on ``time.perf_counter()``, ``call``: the outermost open
    span's id, ``counts``)."""

    __slots__ = ("record", "_fn")

    def __init__(self, name: str, counts: dict):
        self.record = {"id": next(_IDS), "name": name, "t0": None, "t1": None, "call": None,
                       "counts": counts}
        self._fn = None

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        rec = self.record
        rec["call"] = stack[0] if stack else rec["id"]
        stack.append(rec["id"])
        _BUFFER.append(rec)  # in start order; t1 is set on exit
        self._fn = torch.profiler.record_function(rec["name"])
        self._fn.__enter__()
        rec["t0"] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec["t1"] = time.perf_counter()
        self._fn.__exit__(*exc)
        _OPEN.stack.pop()
        return False

    def add(self, **counts) -> None:
        """Add to the span's counts (a missing one starts at 0)."""
        mine = self.record["counts"]
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v


def annotate(name: str, **counts):
    """A named span of the program, as a context manager that yields an
    object whose ``add(**counts)`` adds to the span's counts. While no
    ``torch.profiler`` runs (``trace(dir)``, or any other) it does nothing:
    no ``record_function``, no clock reading, no record. Under a profiler
    the span is a ``record_function(name)`` on the trace's timeline, beside
    the device's events, and a record in memory (``recorded()``) with
    ``counts``; the spans of one API call share the outermost span's id."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, dict(counts))


def recorded():
    """``(records, dropped)``: the span records kept (the last
    ``CAPACITY``, in start order; each a dict as ``annotate`` describes,
    ``t1`` None while the span is open) and how many older ones were
    dropped."""
    with _BUFFER.lock:
        return list(_BUFFER.records), _BUFFER.dropped


class EpochTimer:
    """Host-side per-epoch timing; call ``tick()`` (or use as the pipeline
    ``progress`` callback) once per epoch."""

    def __init__(self):
        self._last = time.perf_counter()
        self.durations = []

    def tick(self, _epoch=None):
        now = time.perf_counter()
        self.durations.append(now - self._last)
        self._last = now

    __call__ = tick

    @property
    def mean(self):
        return sum(self.durations) / len(self.durations) if self.durations else 0.0

    def summary(self) -> str:
        if not self.durations:
            return "no epochs recorded"
        std = statistics.pstdev(self.durations) if len(self.durations) > 1 else 0.0
        return (
            f"{len(self.durations)} epochs: mean={self.mean*1e3:.1f}ms "
            f"std={std*1e3:.1f}ms last={self.durations[-1]*1e3:.1f}ms"
        )


def _window_seconds(fn, depth: int, device) -> float:
    """Seconds for ``depth`` back-to-back runs of ``fn``: CUDA events on
    the card (the device's time, launch gaps included), the host clock on
    the CPU (where every op has finished when it returns)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(depth):
            fn()
        return time.perf_counter() - t0
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(depth):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3


def epoch_anatomy(som, data, *, lo=2, hi=8, reps=3):
    """Decompose one training epoch of ``som`` over ``data`` into
    slope-clean per-stage costs:

    - ``bmu_ms``   — the BMU search over every chunk alone
      (``core._searcher``, then ``core._bmu_chunk`` a chunk),
    - ``stats_ms`` — BMU + sufficient-statistics scatter
      (``core.make_stats_fn``),
    - ``epoch_ms`` — the full epoch step, neighborhood update included
      (``core.make_epoch_step``, epoch 3 of an 8-epoch schedule);
    - derived: ``scatter_ms = stats - bmu``, ``update_ms = epoch - stats``;
    - ``<stage>_method``: how the stage was timed, as in the JAX package;
    - ``<stage>_launches``: each kernel's launches during that stage
      (warm-up included; empty on the CPU, where the plain versions run),
      with ``bmu_argmin.registers``, ``.paired`` or ``.streamed`` for K1's feed
      (``ops.kernels.bmu.search_feed``) and ``.wide`` for its 256-row
      codebook tiles (``ops.kernels.bmu.search_tile``).

    Method (the JAX package's): each stage runs ``lo`` and ``hi`` times
    back to back inside one timed window; the best of ``reps`` windows at
    each depth, and the time delta over the depth delta cancels the
    per-window constant (launch latency, the first launch's wait). A
    window on a card model is timed by CUDA events, on a CPU model by the
    host clock. The data, chunked by ``som._n_parallel``, is uploaded once
    to the model's device by the port's feed (``parallel.pipeline._feed``),
    before any window.

    Single-device measurement (``som`` may carry a mesh for training;
    anatomy runs the unsharded step on this process's device, with the
    full codebook). Leaves the model's weights, random generator and
    checkpoint epoch as they were. Returns a dict of milliseconds plus the
    method descriptors and launch counts."""
    import numpy as np

    from .. import core
    from ..ops import kernels
    from ..parallel.pipeline import _feed

    spec = som._spec
    dist = spec.distance_fn()
    device = som._device
    data2d = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float32)
    chunk = som._n_parallel
    chunks, mask = _feed(data2d, max(1, -(-data2d.shape[0] // chunk)), chunk, device)
    w = torch.from_numpy(np.asarray(som._weights, dtype=np.float32)).to(device)
    stats = core.make_stats_fn(spec)
    step = core.make_epoch_step(spec, 8)  # a static schedule for the decays

    def bmu_only():
        search = core._searcher(spec, dist, w.reshape(spec.xy, spec.input_len))
        for c in range(chunks.shape[0]):
            core._bmu_chunk(spec, search, chunks[c])

    out = {}
    for name, run in (
        ("bmu", bmu_only),
        ("stats", lambda: stats(w, chunks, mask)),
        ("epoch", lambda: step(w, chunks, mask, 3)),
    ):
        before = kernels.launch_counts()
        for depth in (lo, hi):
            _window_seconds(run, depth, device)  # warm-up
        t_min = {
            depth: min(_window_seconds(run, depth, device) for _ in range(reps))
            for depth in (lo, hi)
        }
        if hi > lo and t_min[hi] > t_min[lo]:
            per = (t_min[hi] - t_min[lo]) / (hi - lo)
            method = f"slope({lo},{hi})x{reps}"
        else:  # degenerate window: dispatch-inclusive fallback
            per = t_min[hi] / hi
            method = "direct"
        after = kernels.launch_counts()
        out[f"{name}_ms"] = per * 1e3
        out[f"{name}_method"] = method
        out[f"{name}_launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    out["scatter_ms"] = out["stats_ms"] - out["bmu_ms"]
    out["update_ms"] = out["epoch_ms"] - out["stats_ms"]
    return out
