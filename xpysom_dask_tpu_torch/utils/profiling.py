"""Tracing / profiling hooks (counterpart of
``xpysom_dask_tpu/utils/profiling.py``):

- ``trace(dir)``: context manager around ``torch.profiler`` writing a
  TensorBoard-viewable trace (CPU, and the card where there is one) of
  whatever runs inside (e.g. a training call);
- ``annotate(name)``: a ``record_function`` span, so epoch and
  superbatch boundaries show up as named spans in the trace;
- ``EpochTimer``: lightweight host-side per-epoch wall-clock collector
  (mean/std/last), usable as the ``progress`` callback of the streaming
  pipeline;
- ``epoch_anatomy``: slope-decontaminated decomposition of one training
  epoch into BMU / scatter / update stage costs.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

__all__ = ["trace", "annotate", "EpochTimer", "epoch_anatomy"]


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


def annotate(name: str):
    """Named span visible in profiler traces."""
    return torch.profiler.record_function(name)


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
      (warm-up included; empty on the CPU, where the plain versions run).

    Method (the JAX package's): each stage runs ``lo`` and ``hi`` times
    back to back inside one timed window; the best of ``reps`` windows at
    each depth, and the time delta over the depth delta cancels the
    per-window constant (launch latency, the first launch's wait). A
    window on a card model is timed by CUDA events, on a CPU model by the
    host clock. The data, chunked by ``som._n_parallel``, is uploaded once
    to the model's device.

    Single-device measurement (``som`` may carry a mesh for training;
    anatomy runs the unsharded step on this process's device, with the
    full codebook). Leaves the model's weights, random generator and
    checkpoint epoch as they were. Returns a dict of milliseconds plus the
    method descriptors and launch counts."""
    import numpy as np

    from .. import core
    from ..ops import kernels

    spec = som._spec
    dist = spec.distance_fn()
    device = som._device
    data2d = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float32)
    chunks, mask, _ = core.chunk_data(data2d, som._n_parallel)
    chunks = torch.from_numpy(chunks).to(device)
    mask = torch.from_numpy(mask).to(device)
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
