"""Run one one-card cell traced, as ``run.py --trace 1`` does, and give
the device's idle time in the traced window labelled by the program's
own spans beside the harness's ``breakdown``.

    python3 portbench/idle_by_span.py --workload seismic-fit --seed 3000000001

The rule: where no host operation of the trace covers a gap's middle
(the harness's ``host``), the gap takes the name of the innermost
``user_annotation`` span named ``xpysom.*`` that covers it, after the
call's kind (``train: xpysom.prepare``); ``host`` stays only where none
does. Every other gap keeps the harness's label, so on a trace without
``xpysom.`` spans the labels are the harness's own. No cell loads this
file. It prints the run's result as ``run.py`` does, with ``breakdown``
gaining ``idle_by_span`` (every label, largest first) and ``idle_s``.
"""

import time

STARTED = time.time()  # as run.py's: set-up counts from here

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(ROOT)
sys.path.insert(0, ROOT)

from harness import launch, manifest  # noqa: E402
from harness import trace as tracing  # noqa: E402

SPAN_PREFIX = "xpysom."


def _innermost(items, starts, mid):
    """The name of the shortest ``(start, end, name)`` of ``items`` (sorted
    by start) that covers ``mid``, or None."""
    name, best = None, None
    i = bisect.bisect_right(starts, mid)
    for s, e, n in reversed(items[max(0, i - 256):i]):
        if e >= mid and (best is None or e - s < best):
            name, best = n, e - s
    return name


def idle_by_span(events, top=None):
    """``[[label, seconds], ...]``, largest first: the device's idle time in
    the window of the ``portbench.`` spans, by the rule above."""
    spans = sorted((s, e, ev["name"][len(tracing.PREFIX):])
                   for s, e, ev in tracing._complete(events, ("user_annotation",))
                   if ev["name"].startswith(tracing.PREFIX))
    if not spans:
        return []
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    busy = tracing._merged((max(s, w0), min(e, w1)) for s, e, _ in tracing._complete(events, tracing._DEVICE)
                           if e > w0 and s < w1)
    host = sorted((s, e, ev["name"]) for s, e, ev in tracing._complete(events, tracing._HOST))
    mine = sorted((s, e, ev["name"]) for s, e, ev in tracing._complete(events, ("user_annotation",))
                  if ev["name"].startswith(SPAN_PREFIX))
    hstarts, mstarts = [h[0] for h in host], [m[0] for m in mine]
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    sums = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        kind = next((k for s, e, k in spans if s <= mid <= e), "between calls")
        op = _innermost(host, hstarts, mid) or _innermost(mine, mstarts, mid) or "host"
        label = f"{kind}: {op}"[:200]
        sums[label] = sums.get(label, 0.0) + (g1 - g0) * 1e-6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def run(spec):
    """``(exit code, result or None)`` of a one-card run of ``spec``, traced,
    its ``breakdown`` gaining ``idle_by_span`` and ``idle_s``."""
    kept = {}
    reduce_trace = tracing.reduce_trace

    def keep(events, top=10):
        kept["events"] = events
        return reduce_trace(events, top)

    tracing.reduce_trace = keep  # cell.py looks it up in the module at the call
    try:
        code, result, _ = launch.run(dict(spec, trace=True))
    finally:
        tracing.reduce_trace = reduce_trace
    if code != 0 or result is None:
        return code or 1, None
    gaps = idle_by_span(kept["events"])
    result["breakdown"]["idle_by_span"] = gaps
    result["breakdown"]["idle_s"] = sum(v for _, v in gaps)
    return 0, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    spec = manifest.run_spec(CHECKOUT, args.workload, args.seed, 0.0, True)
    if int(spec["world"]) != 1:
        print("idle_by_span: one-card cells only", file=sys.stderr)
        return 2
    spec["started"] = STARTED
    launch.pin_caches(CHECKOUT)
    code, result = run(spec)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
