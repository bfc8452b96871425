"""The readers of the program's own span records (``metrics/_program.py``:
``host_prep_ms``, ``h2d_bytes_per_row``, ``padded_row_share``), on
synthetic records grouped by their call, and in a traced run on the CPU
at a small size."""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from harness import cell, launch, manifest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
SEED = 2**31 + 4242


def _rec(rid, name, t0, t1, call, **counts):
    return {"id": rid, "name": name, "t0": t0, "t1": t1, "call": call, "counts": counts}


def _ctx():
    """Two fit jobs' calls (train, QE, TE) and two predict calls, each a
    call span with its steps, and beside them steps of no call, a call
    of no part and a call still open."""
    recs = [
        _rec(1, "xpysom.train", 0.1, 9.9, 1, rows=100),
        _rec(2, "xpysom.prepare", 0.2, 0.5, 1, rows=100, padded_rows=128),
        _rec(3, "xpysom.upload", 0.5, 0.6, 1, bytes=1000),
        _rec(4, "xpysom.upload", 0.6, 0.7, 1, bytes=24),
        _rec(5, "xpysom.epoch", 1.0, 5.0, 1),
        _rec(6, "xpysom.quantization_error", 10.0, 12.0, 6, rows=100),
        _rec(7, "xpysom.prepare", 10.1, 10.3, 6, rows=100, padded_rows=128),
        _rec(8, "xpysom.upload", 10.3, 10.4, 6, bytes=500),
        _rec(9, "xpysom.topographic_error", 12.5, 14.0, 9, rows=100),
        _rec(10, "xpysom.prepare", 12.6, 12.7, 9, rows=100, padded_rows=128),
        _rec(11, "xpysom.prepare", 14.2, 14.9, 11, rows=7, padded_rows=8),  # of no call
        _rec(12, "xpysom.predict", 20.0, 21.0, 12, rows=10),
        _rec(13, "xpysom.prepare", 20.1, 20.2, 12, rows=10, padded_rows=16),
        _rec(14, "xpysom.upload", 20.2, 20.3, 12, bytes=160),
        _rec(15, "xpysom.fetch", 20.3, 20.9, 12),
        _rec(16, "xpysom.predict", 21.5, 22.0, 16, rows=30),
        _rec(17, "xpysom.prepare", 21.6, 21.9, 16, rows=30, padded_rows=32),
        _rec(18, "xpysom.upload", 21.9, 21.95, 16, bytes=40),
        _rec(19, "xpysom.predict", 23.0, None, 19),  # open
        _rec(20, "xpysom.prepare", 23.1, 23.2, 19, rows=1, padded_rows=8),
    ]
    return SimpleNamespace(), recs


@pytest.fixture
def program(monkeypatch):
    from xpysom_dask_tpu_torch.utils import profiling

    def use(recs, dropped=0):
        monkeypatch.setattr(profiling, "recorded", lambda: (recs, dropped))
    return use


def _read(name, ctx):
    read, part = cell._reader(PORTBENCH, name)
    return read(ctx, part)


def test_readers_on_synthetic_records(program):
    ctx, recs = _ctx()
    program(recs)
    assert _read("host_prep_ms.train", ctx) == pytest.approx(300.0)
    assert _read("host_prep_ms.score", ctx) == pytest.approx(1e3 * (0.2 + 0.1) / 2)
    assert _read("host_prep_ms.predict", ctx) == pytest.approx(1e3 * (0.1 + 0.3) / 2)
    assert _read("h2d_bytes_per_row.train", ctx) == pytest.approx(1024 / 100)
    assert _read("h2d_bytes_per_row.score", ctx) == pytest.approx(500 / 200)
    assert _read("h2d_bytes_per_row.predict", ctx) == pytest.approx(200 / 40)
    assert _read("padded_row_share.predict", ctx) == pytest.approx(100 * 8 / 48)


@pytest.mark.parametrize("name", ["host_prep_ms.train", "host_prep_ms.predict",
                                  "h2d_bytes_per_row.score", "padded_row_share.predict"])
def test_records_outside_every_call_are_ignored(program, name):
    ctx, recs = _ctx()
    program(recs)
    want = _read(name, ctx)
    program(recs + [_rec(30, "xpysom.prepare", 14.1, 14.3, 30, rows=1, padded_rows=4096),
                    _rec(31, "xpysom.upload", 14.3, 14.4, 30, bytes=10**9),
                    _rec(32, "xpysom.fit", 15.0, 16.0, 32, rows=10**6),  # no part's call
                    _rec(33, "xpysom.upload", 15.1, 15.2, 32, bytes=10**9),
                    _rec(34, "xpysom.upload", 23.3, 23.4, 19, bytes=10**9)])  # an open call's
    assert _read(name, ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_prep_ms.train", "h2d_bytes_per_row.predict",
                                  "padded_row_share.predict"])
def test_no_records_read_nothing(program, monkeypatch, name):
    ctx, recs = _ctx()
    program([])
    assert _read(name, ctx) is None
    program([r for r in recs if r["call"] != r["id"]])  # steps, and no call span
    assert _read(name, ctx) is None
    from xpysom_dask_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")  # a program that keeps no records
    assert _read(name, ctx) is None


def _small(workload):
    spec = manifest.run_spec(CHECKOUT, workload, SEED, 0.05, True)
    spec.update(device="cpu", started=time.time())
    spec["config"]["n_samples"] = 8192
    spec["config"]["som"].update(x=16, y=16, input_len=16, sigma=8)
    if spec["mix"]["kind"] == "predict":
        spec["mix"].update(pool_rows=8192, min_rows=4, max_rows=512, sizes=16, trace_calls=8)
    return spec


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_a_traced_fit_run_reads_the_programs_counts():
    code, result, _ = launch.run(_small("seismic-fit"))
    assert code == 0 and result["correct"]
    m = result["metrics"]
    # 8192 rows of 16 features in one chunk: 64 B of rows, 4 of mask, the
    # 16 KiB codebook a call
    assert m["h2d_bytes_per_row.train"]["value"] == m["h2d_bytes_per_row.score"]["value"] == 70.0
    assert m["host_prep_ms.train"]["value"] > 0 and m["host_prep_ms.score"]["value"] > 0
    assert "padded_row_share.predict" not in m


def test_a_traced_predict_run_reads_the_programs_counts():
    from harness import traffic
    from xpysom_dask_tpu_torch.utils.hw import training_chunk

    spec = _small("seismic-predict-online")
    code, result, _ = launch.run(spec)
    assert code == 0 and result["correct"]
    sizes = [n for _, n in traffic.request_plan(spec["mix"], SEED)]
    sizes = [sizes[i % len(sizes)] for i in range(spec["mix"]["trace_calls"])]
    padded = sum(training_chunk(n, 16384) * -(-n // training_chunk(n, 16384)) for n in sizes)
    d, xy = 16, 16 * 16
    sent = padded * (d + 1) * 4 + len(sizes) * xy * d * 4
    m = result["metrics"]
    assert m["h2d_bytes_per_row.predict"]["value"] == pytest.approx(sent / sum(sizes), rel=1e-12)
    assert m["padded_row_share.predict"]["value"] == pytest.approx(
        100 * (padded - sum(sizes)) / padded, rel=1e-12)
    assert m["host_prep_ms.predict"]["value"] > 0 and np.isfinite(m["host_prep_ms.predict"]["value"])
