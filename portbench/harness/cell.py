"""One run of one cell in one process: set-up, the measured window, the
comparison with the reference, and the metrics. A four-card cell runs
this in each of its processes (``launch.py``); rank 0 returns the
result, the other ranks None.

``spec`` (a dict, JSON-safe) holds: ``root`` (the ``portbench``
directory), ``cell``, ``config``, ``mix`` and ``limits`` (the cell's
entry and the contents of its files), ``metrics`` (the manifest's
entries that this run reports), ``seed``, ``seconds``, ``trace``,
``device`` (``"cuda"``; tests pass ``"cpu"``), ``rank``, ``world``,
``addr`` (the store of a multi-process run), ``started`` (the wall
clock at the process's, or the launcher's, start), ``variant``
(``"program"``, or ``"control"`` for the configuration's lower-precision
control), and optionally ``plant`` (a Python file run first: the tests
plant faults with it), ``tmpdir`` (where a traced run writes its trace,
which it deletes) and ``all_numbers`` (the result also carries every
number of the check, for ``calibrate.py``).
"""

from __future__ import annotations

import collections
import gc
import hashlib
import importlib
import importlib.util
import os
import runpy
import sys
import time
import traceback
from contextlib import nullcontext

import numpy as np

from . import check, guard, peaks, traffic
from . import trace as tracing

__all__ = ["run", "load_file_module", "make_rows", "initial_codebook", "som_arguments"]


def load_file_module(path: str, name: str):
    """Import the Python file ``path`` as module ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = module
    mod_spec.loader.exec_module(module)
    return module


def make_rows(torch, device, seed: int, rows: int, d: int) -> np.ndarray:
    """``rows`` x ``d`` float32 rows, uniform on [0, 1), drawn on the
    device from ``seed`` in one call and copied to host memory."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return torch.rand((rows, d), generator=g, device=device, dtype=torch.float32).cpu().numpy()


def initial_codebook(X: np.ndarray, x: int, y: int, seed: int) -> np.ndarray:
    """``x * y`` rows of ``X`` drawn from ``seed`` (what
    ``random_weights_init`` does), as an (x, y, D) float32 codebook."""
    idx = traffic.rng(seed, 1).integers(0, X.shape[0], x * y)
    return np.ascontiguousarray(X[idx].reshape(x, y, X.shape[1]))


def som_arguments(config: dict, variant: str = "program") -> dict:
    """The keyword arguments of ``XPySom.from_numpy`` for the
    configuration; the control variant adds the configuration's
    ``control.som`` arguments."""
    kw = {k: v for k, v in config["som"].items() if k not in ("x", "y", "input_len")}
    if variant == "control":
        kw.update(config.get("control", {}).get("som", {}))
    return kw


class _Recorder:
    """Host-clock spans of the calls into the program; in a traced window
    each call is also a ``record_function`` span of the profiler."""

    def __init__(self, traced: bool):
        self.spans = []
        self._traced = traced

    def call(self, kind, fn, **info):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(tracing.PREFIX + kind) if self._traced else nullcontext():
            out = fn()
        self.spans.append(dict(kind=kind, t0=t0, t1=time.perf_counter(), **info))
        return out


class _Mesh:
    """The harness's own collectives between the ranks of a four-card
    cell, outside every timed call; a no-op for one process."""

    def __init__(self, torch, world, device):
        self.torch, self.world, self.device = torch, world, device

    def rank0_says(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        t = self.torch.tensor([1 if flag else 0], device=self.device)
        self.torch.distributed.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        self.torch.distributed.all_gather_object(out, obj)
        return out


def _fit_window(som, X, w0, mix, rec, mesh, until, epochs=None):
    """Fit jobs until ``until(jobs)`` says the window is closed (rank 0
    decides for every rank). Returns ``(jobs, failed, last outputs,
    first error)``. ``epochs`` overrides the mix's (set-up's warm-up
    job trains one epoch: the same shapes and kernels)."""
    epochs, n = int(epochs or mix["epochs"]), X.shape[0]
    jobs = failed = 0
    last, error = None, None
    while True:
        try:
            np.copyto(som.get_weights(), w0)
            rec.call("train", lambda: som.train(X, epochs), rows=n, epochs=epochs)
            qe = rec.call("qe", lambda: som.quantization_error(X), rows=n)
            te = rec.call("te", lambda: som.topographic_error(X), rows=n)
            last = (som.get_weights().copy(), qe, te)
        except Exception:  # a failed job counts against those attempted
            failed += 1
            last, error = None, error or traceback.format_exc()
        jobs += 1
        if mesh.rank0_says(until(jobs)):
            return jobs, failed, last, error


def _predict_window(som, pool, mix, seed, rec, until):
    """Requests until ``until(requests)``; keeps the winners of the
    requests the check compares."""
    plan = traffic.request_plan(mix, seed)
    sample = traffic.check_sample(mix, seed)
    last = collections.deque(maxlen=int(mix["check_last"]))
    kept, i, failed, error = [], 0, 0, None
    while True:
        off, n = plan[i % len(plan)]
        try:
            win = rec.call("predict", lambda: som.predict(pool[off:off + n]), rows=n)
        except Exception:
            failed += 1
            win, error = np.empty(0, dtype=np.int64), error or traceback.format_exc()
        entry = (off, n, win)
        if i < len(sample) and sample[i]:
            kept.append(entry)
        else:
            last.append(entry)
        i += 1
        if until(i):
            return i, failed, kept + list(last), error


def _segments(som, X, w0, epochs, which):
    """The program's codebook at each of ``check.segment_marks``: the
    window's ``train`` entry again, from the initial codebook, in
    segments (``iter_beg``, ``iter_end``)."""
    states = {0: w0}
    np.copyto(som.get_weights(), w0)
    marks = check.segment_marks(epochs, which)
    for a, b in zip(marks, marks[1:]):
        som.train(X, epochs, iter_beg=a, iter_end=b)
        states[b] = som.get_weights().copy()
    return states


def _warm_predict(som, pool, mix, seed):
    """Every distinct request size once, smallest to largest, so the
    window allocates nothing new."""
    for n in sorted({n for _, n in traffic.request_plan(mix, seed)}):
        som.predict(pool[:n])


def run(spec: dict):
    import torch

    root = spec["root"]
    sys.path.insert(0, os.path.dirname(root))  # the checkout: the program's package
    if spec.get("plant"):
        runpy.run_path(spec["plant"], run_name="portbench_plant")
    from xpysom_dask_tpu_torch import XPySom

    rank, world = int(spec.get("rank", 0)), int(spec.get("world", 1))
    config, mix, seed = spec["config"], spec["mix"], int(spec["seed"])
    on_card = spec["device"] == "cuda"
    meshed = mix.get("mesh") is not None
    if meshed:
        from xpysom_dask_tpu_torch.parallel import initialize_multihost

        initialize_multihost(spec["addr"], world, rank, device=None if on_card else "cpu")
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    mesh = _Mesh(torch, world, device)

    kw = som_arguments(config, spec.get("variant", "program"))
    kw["random_seed"] = seed % (1 << 32)
    if not on_card:
        kw["device"] = "cpu"
    if meshed:
        kw["mesh"] = mix["mesh"]
    fit = mix["kind"] == "fit"
    rows = int(config["n_samples"]) if fit else int(mix["pool_rows"])
    marks = [("start", float(spec["started"])), ("imports", time.time())]
    X = make_rows(torch, device, seed, rows, config["som"]["input_len"])
    w0 = initial_codebook(X, config["som"]["x"], config["som"]["y"], seed)
    marks.append(("data", time.time()))
    som = XPySom.from_numpy(w0, **kw)  # a float32 codebook, as after training

    # set-up ends with one warm-up at the cell's own shapes
    if fit:
        _fit_window(som, X, w0, mix, _Recorder(False), mesh, lambda jobs: True, epochs=1)
    else:
        _warm_predict(som, pool=X, mix=mix, seed=seed)
    found = guard.forbidden_modules()
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded after set-up: {found}")
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    traced = bool(spec["trace"])
    rec = _Recorder(traced)
    t_open = time.perf_counter()
    window_start = time.time()
    marks.append(("warm-up", window_start))
    if traced:
        calls = int(mix["trace_calls"])

        def until(k):
            return k >= calls
    else:
        def until(k):
            return time.perf_counter() - t_open >= float(spec["seconds"])

    with tracing.profile(torch, spec["tmpdir"], f"rank{rank}") if traced else nullcontext() as prof:
        if fit:
            attempted, failed, last, error = _fit_window(som, X, w0, mix, rec, mesh, until)
        else:
            attempted, failed, last, error = _predict_window(som, X, mix, seed, rec, until)
    found = guard.forbidden_modules()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if error:
        print(f"portbench: rank {rank}: a call failed:\n{error}", file=sys.stderr)
    if rank == 0:
        _tell(marks, rec.spans)

    which = config.get("checked_epochs", check.EPOCHS)
    states = _segments(som, X, w0, int(mix["epochs"]), which) if fit and last else None
    # the program's state goes before the reference runs
    digest = hashlib.sha256(last[0].tobytes()).hexdigest() if fit and last else None
    del som
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reduced = tracing.reduce_trace(prof.events) if traced else None
    report = {"spans": rec.spans, "trace": reduced, "peak": peak, "digest": digest,
              "found": found, "failed": failed}
    reports = mesh.gather(report)

    numbers = None
    if rank == 0:
        numbers = _numbers(torch, spec, config, mix, device, X, w0, last, states, fit)
        if meshed:
            numbers["ranks_apart"] = sum(r["digest"] != digest for r in reports)
    mesh.rank0_says(True)  # every rank waits for the reference
    if rank != 0:
        return None
    return _result(torch, spec, reports, numbers, attempted, window_start, on_card)


def _tell(marks, spans):
    """Set-up's phases and each kind of call's wall times, on standard
    error."""
    phases = ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
    print(f"portbench: set-up: {phases}", file=sys.stderr)
    for kind in dict.fromkeys(s["kind"] for s in spans):
        ms = sorted(1e3 * (s["t1"] - s["t0"]) for s in spans if s["kind"] == kind)
        print(f"portbench: {kind}: {len(ms)} calls, ms min {ms[0]:.3f} median {ms[len(ms) // 2]:.3f} "
              f"max {ms[-1]:.3f}", file=sys.stderr)


def _numbers(torch, spec, config, mix, device, X, w0, last, states, fit):
    ref = load_file_module(os.path.join(spec["root"], config["reference"]), "portbench_reference")
    cfg = ref.SomConfig.from_som_kwargs(config["som"])
    if fit:
        if last is None:
            return {k: float("inf") for k in spec["limits"]}
        final, qe, te = last
        return check.fit_numbers(torch, ref, cfg, device, X, int(mix["epochs"]), states, final, qe, te,
                                 config.get("checked_epochs", check.EPOCHS))
    return check.predict_numbers(torch, ref, cfg, device, X, w0, last)


class Context:
    """What a metric's reader reads: ``spans`` (each rank's host-clock
    spans of the window, a list per rank), ``calls`` (each rank's traced
    calls, a list per rank; None in an untraced run), ``config``,
    ``mix``, ``cell``, and :meth:`least_s`, a call's least time from the
    work counts of ``work/<activation>.py`` and the peaks."""

    def __init__(self, spec, reports):
        self.config, self.mix, self.cell = spec["config"], spec["mix"], spec["cell"]
        self.world = int(spec.get("world", 1))
        self.spans = [r["spans"] for r in reports]
        self.calls = None if reports[0]["trace"] is None else [r["trace"]["calls"] for r in reports]
        work = self.config["work"]
        if spec["root"] not in sys.path:
            sys.path.insert(0, spec["root"])
        self._work = {kind: importlib.import_module(f"work.{name}") for kind, name in work.items()}

    def least_s(self, call: dict) -> float:
        """The least time of one call of this rank (``rows`` are the
        rows the call was given; a mesh divides them over its ranks):
        the largest of each resource's amount over its peak."""
        som = self.config["som"]
        x, y, d = som["x"], som["y"], som["input_len"]
        n = call["rows"] / (self.world if self.mix.get("mesh") is not None else 1)
        kind = call["kind"]
        if kind == "train":
            w = self._work["train"]
            amount = {k: v * call["epochs"] for k, v in w.epoch(n, x, y, d).items()}
        else:
            amount = self._work["score" if kind in ("qe", "te") else kind].search(n, x * y, d)
        return max(amount.get("tensor_flops", 0.0) / peaks.BF16_FLOPS,
                   amount.get("fp32_instr", 0.0) / peaks.FP32_INSTR,
                   amount.get("bytes", 0.0) / peaks.HBM_BYTES)


def _reader(root, name):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py`` given the rest as its
    part."""
    folder = os.path.join(root, "metrics")
    if folder not in sys.path:
        sys.path.insert(0, folder)  # the readers' shared helpers
    whole = os.path.join(folder, f"{name}.py")
    if os.path.exists(whole):
        return load_file_module(whole, f"portbench_metric_{name}").read, None
    base, _, part = name.partition(".")
    module = load_file_module(os.path.join(root, "metrics", f"{base}.py"), f"portbench_metric_{base}")
    return module.read, part or None


def _result(torch, spec, reports, numbers, attempted, window_start, on_card):
    ctx = Context(spec, reports)
    metrics = {}
    for m in spec["metrics"]:
        if m["name"] == "setup_s":
            value = window_start - float(spec["started"])
        else:
            read, part = _reader(spec["root"], m["name"])
            value = read(ctx, part)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r["failed"] for r in reports)
    correct, compared = check.verdict(numbers, spec["limits"])
    found = sorted({f for r in reports for f in r["found"]})
    device = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(spec.get("world", 1)),
        "memory_peak_bytes": max(r["peak"] for r in reports),
    }
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if reports[0]["trace"] is not None:
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in reports) / len(reports)
        device["window_s"] = sum(r["trace"]["window_s"] for r in reports) / len(reports)
        t0 = reports[0]["trace"]
        result["breakdown"] = {"device_ops": t0["device_ops"], "idle_gaps": t0["idle_gaps"]}
    if spec.get("all_numbers"):
        result["numbers"] = numbers  # every reading, for calibrate.py
    result["checks"] = compared
    return result, found
