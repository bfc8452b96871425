"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer readers read.

The harness wraps each call into the program in a ``record_function``
span named ``portbench.<kind>`` (``train``, ``qe``, ``te``,
``predict``). Every call ends synchronized (it returns host values), so
the device work of a call lies inside its span. For each span this
module sums, from the trace's device events (kernels, copies, sets):
the wall time, the device-busy time (the union of all device events),
the kernel-busy time (the union of kernels), the host-to-device copy
time, the number of kernels and the time of NCCL kernels. Over the
whole traced window it gives the busy time, the device operations that
took most time and the device's idle time by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os

__all__ = ["PREFIX", "profile", "reduce_trace"]

PREFIX = "portbench."
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver")


class profile:
    """A ``torch.profiler`` window over CPU and CUDA activity; on exit the
    trace is written under ``tmpdir``, read back and deleted, and its
    events are kept in ``events``."""

    def __init__(self, torch, tmpdir: str, name: str):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as _profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = _profile(activities=activities)
        self._path = os.path.join(tmpdir, f"{name}.{os.getpid()}.trace.json")
        self.events = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self._path)
            try:
                with open(self._path) as f:
                    data = json.load(f)
            finally:
                os.unlink(self._path)
            self.events = data["traceEvents"] if isinstance(data, dict) else data
        return False


def _merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted, disjoint
    ``[start, end]`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


def _complete(events, cats):
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            yield float(e["ts"]), float(e["ts"]) + float(e["dur"]), e


def reduce_trace(events, top: int = 10) -> dict:
    """``{"calls": [...], "busy_s", "window_s", "device_ops", "idle_gaps"}``
    from a chrome trace's events; times in seconds. ``calls`` has one
    entry per ``portbench.<kind>`` span, in order."""
    spans = sorted((s, e, ev["name"][len(PREFIX):]) for s, e, ev in _complete(events, ("user_annotation",))
                   if ev["name"].startswith(PREFIX))
    device = sorted((s, e, ev["cat"], ev["name"]) for s, e, ev in _complete(events, _DEVICE))
    starts = [d[0] for d in device]
    calls = []
    for s0, s1, kind in spans:
        inside = [(max(s, s0), min(e, s1), cat, name)
                  for s, e, cat, name in device[bisect.bisect_left(starts, s0):bisect.bisect_right(starts, s1)]]
        calls.append({
            "kind": kind,
            "wall_s": (s1 - s0) * 1e-6,
            "busy_s": _length((s, e) for s, e, _, _ in inside) * 1e-6,
            "kernel_busy_s": _length((s, e) for s, e, c, _ in inside if c == "kernel") * 1e-6,
            "h2d_s": sum(e - s for s, e, c, n in inside if c == "gpu_memcpy" and "HtoD" in n) * 1e-6,
            "kernels": sum(1 for _, _, c, _ in inside if c == "kernel"),
            "nccl_s": sum(e - s for s, e, c, n in inside if c == "kernel" and "nccl" in n.lower()) * 1e-6,
        })
    if not spans:
        return {"calls": [], "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    inside = [(max(s, w0), min(e, w1), c, n) for s, e, c, n in device if e > w0 and s < w1]
    busy = _merged((s, e) for s, e, _, _ in inside)
    by_name = {}
    for s, e, _, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "calls": calls,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n[:200], v] for n, v in device_ops],
        "idle_gaps": _idle_by_host(events, spans, busy, w0, w1, top),
    }


def _idle_by_host(events, spans, busy, w0, w1, top):
    """The device's idle time inside the traced window, summed by what
    the host was doing at the middle of each gap: the innermost host
    operation there, after the call's kind (``host`` where no operation
    of the trace covers it)."""
    host = sorted((s, e, ev["name"]) for s, e, ev in _complete(events, _HOST))
    hstarts = [h[0] for h in host]
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    sums = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        kind = next((k for s, e, k in spans if s <= mid <= e), "between calls")
        op, best = "host", None
        i = bisect.bisect_right(hstarts, mid)
        for s, e, name in reversed(host[max(0, i - 256):i]):
            if e >= mid and (best is None or e - s < best):
                op, best = name, e - s
        label = f"{kind}: {op}"[:200]
        sums[label] = sums.get(label, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
