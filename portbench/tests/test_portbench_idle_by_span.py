"""``idle_by_span.py``: the device's idle gaps labelled by the program's
own ``xpysom.`` spans, on a synthetic chrome trace and in a traced run on
the CPU at a small size."""

import os
import time

import pytest

import idle_by_span
from harness import manifest
from harness import trace as tracing

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 4242


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events(spans=True):
    """One ``portbench.train`` call over [0, 100] us with device work at
    [0, 10], [40, 60] and [90, 100]: a gap [10, 40] under only the
    program's ``xpysom.prepare``, a gap [60, 90] under an ``aten::``
    operation; then a ``portbench.qe`` call over [120, 150] whose gap
    [130, 150] lies under only the call span ``xpysom.quantization_error``."""
    ev = [_x("portbench.train", "user_annotation", 0, 100),
          _x("portbench.qe", "user_annotation", 120, 30),
          _x("search", "kernel", 0, 10), _x("Memcpy HtoD", "gpu_memcpy", 40, 20),
          _x("search", "kernel", 90, 10), _x("search", "kernel", 120, 10),
          _x("aten::copy_", "cpu_op", 62, 26), _x("cudaLaunchKernel", "cuda_runtime", 119, 2)]
    if spans:
        ev += [_x("xpysom.train", "user_annotation", 1, 98),
               _x("xpysom.prepare", "user_annotation", 11, 28),
               _x("xpysom.quantization_error", "user_annotation", 121, 28)]
    return ev


def test_a_gap_under_only_a_program_span_takes_its_name():
    got = dict(idle_by_span.idle_by_span(_events()))
    assert got == pytest.approx({"train: xpysom.prepare": 30e-6, "train: aten::copy_": 30e-6,
                                 "between calls: host": 20e-6, "qe: xpysom.quantization_error": 20e-6})


def test_a_gap_under_a_host_operation_keeps_its_label():
    ev = _events() + [_x("aten::zeros", "cpu_op", 20, 10)]  # inside xpysom.prepare
    got = dict(idle_by_span.idle_by_span(ev))
    assert got["train: aten::zeros"] == pytest.approx(30e-6) and "train: xpysom.prepare" not in got


def test_without_program_spans_the_labels_are_the_harness_own():
    ev = _events(spans=False)
    want = tracing.reduce_trace(ev, top=100)["idle_gaps"]
    got = idle_by_span.idle_by_span(ev)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [v for _, v in got] == pytest.approx([v for _, v in want])
    assert dict(got)["train: host"] == pytest.approx(30e-6)


def test_no_call_span_no_gaps():
    assert idle_by_span.idle_by_span([_x("xpysom.prepare", "user_annotation", 0, 10)]) == []


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_a_traced_run_gives_the_harness_result_and_the_labels():
    spec = manifest.run_spec(CHECKOUT, "seismic-predict-online", SEED, 0.0, True)
    spec.update(device="cpu", started=time.time())
    spec["config"]["som"].update(x=16, y=16, input_len=16, sigma=8)
    spec["mix"].update(pool_rows=8192, min_rows=4, max_rows=512, sizes=16, trace_calls=8)
    reduce_trace = tracing.reduce_trace
    code, result = idle_by_span.run(spec)
    assert tracing.reduce_trace is reduce_trace  # put back
    assert code == 0 and result["correct"] and "padded_row_share.predict" in result["metrics"]
    gaps = result["breakdown"]["idle_by_span"]
    assert result["breakdown"]["idle_s"] == pytest.approx(sum(v for _, v in gaps))
    assert all(k.split(": ", 1)[0] in ("predict", "between calls") for k, _ in gaps)
