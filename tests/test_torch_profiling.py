"""The port's own spans (``utils.profiling.annotate``) on the API path, on
the CPU: nothing while no profiler runs, and under one a record per span
(``recorded()``) beside a ``record_function`` on the trace's timeline."""

import os

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.core import chunk_data
from xpysom_dask_tpu_torch.ops.kernels.bmu import FEED_REGISTERS
from xpysom_dask_tpu_torch.utils import profiling
from xpysom_dask_tpu_torch.utils.hw import training_chunk

CALLS = ["train", "quantization_error", "topographic_error", "predict"]
ROWS, D, CHUNK = 300, 3, 128  # 300 rows in 3 chunks of 128: 84 rows of padding
EPOCHS, BEG, END = 4, 1, 3


def _som():
    return XPySom(4, 5, D, device="cpu", random_seed=0, n_parallel=CHUNK)


def _data():
    return np.random.RandomState(0).rand(ROWS, D).astype(np.float32)


def _call(som, name, data):
    if name == "train":
        return som.train(data, EPOCHS, iter_beg=BEG, iter_end=END)
    return getattr(som, name)(data)


def _new_records(before):
    last = max((r["id"] for r in before), default=0)
    return [r for r in profiling.recorded()[0] if r["id"] > last]


@pytest.mark.parametrize("name", CALLS)
def test_without_a_profiler_a_call_records_nothing(monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    som, data = _som(), _data()
    before = profiling.recorded()
    _call(som, name, data)
    assert profiling.recorded() == before


@pytest.mark.parametrize("name", CALLS)
def test_under_a_profiler_each_step_of_a_call_is_a_span(tmp_path, name):
    som, data = _som(), _data()
    _call(som, name, data)  # warm
    before = profiling.recorded()[0]
    with profiling.trace(tmp_path):
        _call(som, name, data)
    recs = _new_records(before)
    root, steps = recs[0], recs[1:]
    # the search's codebook is built in each epoch, or once a scoring call
    built = ["xpysom.epoch", "xpysom.codebook"] * (END - BEG) if name == "train" else [
        "xpysom.codebook"]
    # two uploads: the caller's rows, then the codebook (the padding and the
    # mask are made on the device)
    assert [r["name"] for r in recs] == (
        [f"xpysom.{name}", "xpysom.prepare"] + ["xpysom.upload"] * 2 + built + ["xpysom.fetch"])
    # a scoring or training call counts its K1 and K2 launches (none on the
    # CPU, where the plain versions run)
    counted = {} if name == "predict" else {"searches": 0, "streamed_searches": 0}
    assert root["call"] == root["id"] and root["counts"] == {"rows": ROWS, **counted}
    assert all(r["call"] == root["id"] for r in steps)
    assert root["t0"] <= steps[0]["t0"] and steps[-1]["t1"] <= root["t1"]
    # the steps follow each other; a codebook's build lies inside its epoch
    outer = [r for r in steps if r["name"] != "xpysom.codebook" or name != "train"]
    assert all(a["t0"] <= a["t1"] <= b["t0"] <= b["t1"] for a, b in zip(outer, outer[1:]))
    for epoch, book in zip(steps, steps[1:]):
        if book["name"] == "xpysom.codebook" and name == "train":
            assert epoch["t0"] <= book["t0"] <= book["t1"] <= epoch["t1"]
    assert all(r["counts"] == {} for r in steps if r["name"] == "xpysom.epoch")
    # its units, the packed operand's padded depth (3 * 3 + 3 -> 16) and
    # the feed: A held in registers at that depth
    assert all(r["counts"] == {"units": 4 * 5, "depth": 16, "feed": FEED_REGISTERS}
               for r in steps if r["name"] == "xpysom.codebook")

    chunks, _, _ = chunk_data(data, training_chunk(ROWS, CHUNK))
    codebook = np.asarray(som.get_weights(), dtype=np.float32)
    assert steps[0]["counts"] == {"rows": ROWS, "padded_rows": chunks.shape[0] * chunks.shape[1]}
    assert steps[0]["counts"]["padded_rows"] == 384
    # the codebook's upload counts its units (rows), the rows' upload none
    assert [r["counts"] for r in steps if r["name"] == "xpysom.upload"] == [
        {"bytes": data.nbytes}, {"bytes": codebook.nbytes, "units": 4 * 5}]
    # train's fetch is the codebook's, and counts its bytes; the others
    # read a scalar or the winners
    fetched = {"bytes": codebook.nbytes} if name == "train" else {}
    assert steps[-1]["counts"] == fetched

    written = "".join(open(os.path.join(d, f)).read() for d, _, fs in os.walk(tmp_path) for f in fs)
    for r in recs:
        assert f'"{r["name"]}"' in written


def test_spans_nest_share_their_call_and_add_counts():
    before = profiling.recorded()[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("xpysom.outer", rows=2) as outer:
            outer.add(rows=3, bytes=4)
            with profiling.annotate("xpysom.inner"):
                with profiling.annotate("xpysom.innermost", bytes=1) as inner:
                    inner.add(bytes=1)
                    assert _new_records(before)[-1]["t1"] is None  # open
            with pytest.raises(ValueError):
                with profiling.annotate("xpysom.failed"):
                    raise ValueError("closed all the same")
        with profiling.annotate("xpysom.next"):
            pass
    outer, inner, innermost, failed, nxt = _new_records(before)
    assert outer["counts"] == {"rows": 5, "bytes": 4} and innermost["counts"] == {"bytes": 2}
    assert {r["call"] for r in (outer, inner, innermost, failed)} == {outer["id"]}
    assert nxt["call"] == nxt["id"]
    assert failed["t1"] is not None and outer["t0"] <= innermost["t0"] <= innermost["t1"] <= outer["t1"]
    off = profiling.annotate("xpysom.off", rows=1)  # no profiler: nothing kept
    with off as span:
        span.add(rows=1)
    assert _new_records(before)[-1] is nxt


def test_the_buffer_keeps_the_last_records_and_counts_the_dropped(monkeypatch):
    assert profiling.CAPACITY == 65536 and profiling._BUFFER.records.maxlen == profiling.CAPACITY
    monkeypatch.setattr(profiling, "_BUFFER", profiling._Buffer(4))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(6):
            with profiling.annotate(f"xpysom.s{i}"):
                pass
    recs, dropped = profiling.recorded()
    assert [r["name"] for r in recs] == [f"xpysom.s{i}" for i in range(2, 6)] and dropped == 2
