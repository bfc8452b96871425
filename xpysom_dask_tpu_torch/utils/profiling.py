"""Tracing / profiling hooks (counterpart of
``xpysom_dask_tpu/utils/profiling.py``):

- ``trace(dir)``: context manager around ``torch.profiler`` writing a
  TensorBoard-viewable trace (CPU, and the card where there is one) of
  whatever runs inside (e.g. a training call);
- ``annotate(name)``: a ``record_function`` span, so epoch and
  superbatch boundaries show up as named spans in the trace;
- ``EpochTimer``: lightweight host-side per-epoch wall-clock collector
  (mean/std/last), usable as the ``progress`` callback of the streaming
  pipeline.

The JAX package's ``epoch_anatomy`` (a scan-slope decomposition of one
epoch) is not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

__all__ = ["trace", "annotate", "EpochTimer"]


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
