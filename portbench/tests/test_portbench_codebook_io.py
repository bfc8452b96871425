"""``codebook_io_ms``: the host time of the codebook's upload (an
``xpysom.upload`` span that counts ``units``) and fetch (an
``xpysom.fetch`` span that counts ``bytes``) per call, on synthetic
records; nothing on a program whose spans carry neither count."""

import os
from types import SimpleNamespace

import pytest

from harness import cell

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rec(rid, name, t0, t1, call, **counts):
    return {"id": rid, "name": name, "t0": t0, "t1": t1, "call": call, "counts": counts}


def _records(counted=True):
    """Two fit jobs and a predict request; ``counted=False`` drops the
    counts this metric reads, as a program older than them records."""
    def c(**counts):
        return counts if counted else {k: v for k, v in counts.items() if k == "bytes"}

    fetch = {"bytes": 4000} if counted else {}
    return [
        _rec(1, "xpysom.train", 0.0, 10.0, 1, rows=100),
        _rec(2, "xpysom.upload", 0.1, 0.2, 1, bytes=400),  # the rows
        _rec(3, "xpysom.upload", 0.2, 0.5, 1, **c(bytes=4000, units=10)),
        _rec(4, "xpysom.epoch", 0.5, 4.5, 1),
        _rec(5, "xpysom.epoch", 4.5, 9.0, 1),
        _rec(6, "xpysom.fetch", 9.0, 9.4, 1, **fetch),
        _rec(7, "xpysom.quantization_error", 11.0, 12.0, 7, rows=100),
        _rec(8, "xpysom.upload", 11.1, 11.2, 7, bytes=400),
        _rec(9, "xpysom.upload", 11.2, 11.5, 7, **c(bytes=4000, units=10)),
        _rec(10, "xpysom.fetch", 11.8, 11.9, 7),  # a scalar
        _rec(11, "xpysom.topographic_error", 12.0, 13.0, 11, rows=100),
        _rec(12, "xpysom.upload", 12.1, 12.2, 11, bytes=400),
        _rec(13, "xpysom.upload", 12.2, 12.3, 11, **c(bytes=4000, units=10)),
        _rec(14, "xpysom.train", 20.0, 30.0, 14, rows=100),
        _rec(15, "xpysom.upload", 20.1, 20.2, 14, bytes=400),
        _rec(16, "xpysom.upload", 20.2, 20.7, 14, **c(bytes=4000, units=10)),
        _rec(17, "xpysom.fetch", 29.0, 29.2, 14, **fetch),
        _rec(18, "xpysom.predict", 40.0, 40.5, 18, rows=10),
        _rec(19, "xpysom.upload", 40.1, 40.11, 18, bytes=40),
        _rec(20, "xpysom.upload", 40.11, 40.31, 18, **c(bytes=4000, units=10)),
        _rec(21, "xpysom.fetch", 40.4, 40.45, 18),  # the winners
        _rec(22, "xpysom.upload", 41.0, 45.0, 22, bytes=10**9, units=10**6),  # of no call
    ]


@pytest.fixture
def program(monkeypatch):
    from xpysom_dask_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "recorded", lambda: (recs, 0))
    return use


def _read(part):
    read, name = cell._reader(PORTBENCH, f"codebook_io_ms.{part}")
    return read(SimpleNamespace(), name)


def test_the_codebooks_upload_and_fetch_per_call(program):
    program(_records())
    assert _read("train") == pytest.approx(1e3 * ((0.3 + 0.4) + (0.5 + 0.2)) / 2)
    assert _read("score") == pytest.approx(1e3 * (0.3 + 0.1) / 2)
    assert _read("predict") == pytest.approx(1e3 * 0.2)


@pytest.mark.parametrize("part", ["train", "score", "predict"])
def test_a_program_without_the_counts_reads_nothing(program, monkeypatch, part):
    program(_records(counted=False))
    assert _read(part) is None
    program([])
    assert _read(part) is None
    from xpysom_dask_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")  # a program that keeps no records
    assert _read(part) is None
