"""The PyTorch port's streaming pipeline and native chunk loader on the
CPU: twins of ``tests/test_pipeline_serialization.py``'s streaming tests
and of ``tests/test_native_loader.py``. Streamed training equals resident
training in the port bit for bit (superbatches of whole chunks, a ragged
last one included) and stays within JAX's own streaming tolerance of the
JAX package's streamed run; streamed ``predict`` and
``activation_response`` equal the resident results bit for bit. Inputs are
made with numpy from fixed seeds."""

import ctypes

import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu.parallel import pipeline as jax_pipeline
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.core import SomSpec, chunk_data
from xpysom_dask_tpu_torch.parallel import pipeline
from xpysom_dask_tpu_torch.parallel.pipeline import (
    ArraySource,
    FileSource,
    IterableSource,
    ShardedFileSource,
    train_streaming,
)
from xpysom_dask_tpu_torch.utils.native import load_chunkloader, native_available

# the JAX package's streamed-against-resident tolerance
# (tests/test_pipeline_serialization.py)
RTOL, ATOL = 1e-4, 1e-5


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _som(x, y, d, **kw):
    return XPySom(x, y, d, device="cpu", **kw)


@pytest.fixture
def dataset(tmp_path):
    data = np.random.RandomState(0).rand(1000, 6).astype(np.float32)
    f = tmp_path / "data.f32"
    data.tofile(f)
    return f, data


@pytest.fixture
def needs_native():
    if not native_available():
        pytest.skip("native toolchain (g++) unavailable")


# superbatch rows: the default (one superbatch), 128 (two chunks of 64 per
# superbatch, a ragged last one of 60 rows) and 64 (one chunk each)
@pytest.mark.parametrize("rows", [None, 128, 64])
def test_streaming_matches_resident_bitwise(rows):
    data = np.random.RandomState(0).rand(700, 5).astype(np.float32)
    resident = _som(6, 6, 5, random_seed=3, n_parallel=64).train(data, 4)
    streamed = _som(6, 6, 5, random_seed=3, n_parallel=64)
    if rows is not None:
        streamed._superbatch_rows = lambda: rows
    streamed.train(ArraySource(data), 4)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))


def test_streaming_matches_jax_streaming():
    data = np.random.RandomState(0).rand(700, 5).astype(np.float32)
    ours = _som(6, 6, 5, random_seed=3, n_parallel=64)
    ours._superbatch_rows = lambda: 128
    ours.train(ArraySource(data), 4)
    w0 = np.asarray(JaxSom(6, 6, 5, random_seed=3)._weights, np.float32)
    spec = JaxSom(6, 6, 5, random_seed=3)._spec
    ref = jax_pipeline.train_streaming(spec, w0, jax_pipeline.ArraySource(data), 4, chunk=64,
                                       superbatch_rows=128)
    np.testing.assert_allclose(ours._weights, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_streaming_memmap(tmp_path):
    data = np.random.RandomState(1).rand(300, 4).astype(np.float32)
    f = tmp_path / "data.f32"
    data.tofile(f)
    mm = np.memmap(f, dtype=np.float32, mode="r", shape=(300, 4))
    resident = _som(5, 5, 4, random_seed=2, n_parallel=64).train(data, 3)
    streamed = _som(5, 5, 4, random_seed=2, n_parallel=64).train(mm, 3)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))


def test_streaming_small_superbatches():
    """Superbatches that are not whole chunks (50 rows of chunk 32, uneven
    tail): other chunks, so JAX's tolerance, not bits."""
    data = np.random.RandomState(2).rand(333, 3).astype(np.float32)
    som = _som(4, 4, 3, random_seed=1, n_parallel=32)
    w = train_streaming(som._spec, som._weights, ArraySource(data), 3, chunk=32,
                        superbatch_rows=50, device="cpu")
    resident = _som(4, 4, 3, random_seed=1, n_parallel=32).train(data, 3)
    np.testing.assert_allclose(w, resident._weights, rtol=RTOL, atol=ATOL)


def test_iterable_source_matches_resident():
    data = np.random.RandomState(8).rand(450, 4).astype(np.float32)

    def factory():
        for start in range(0, 450, 77):  # ragged producer batches
            yield data[start : start + 77]

    resident = _som(5, 5, 4, random_seed=6, n_parallel=64).train(data, 3)
    streamed = _som(5, 5, 4, random_seed=6, n_parallel=64)
    streamed.train(IterableSource(factory, 450, 4), 3)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))


def test_iterable_source_reblocks():
    data = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)

    def factory():
        yield data[:37]
        yield data[37:90]
        yield data[90:]

    src = IterableSource(factory, 100, 2)
    blocks = list(src.superbatches(40))
    assert [b.shape[0] for b in blocks] == [40, 40, 20]
    np.testing.assert_array_equal(np.concatenate(blocks), data)
    np.testing.assert_array_equal(np.concatenate(list(src.superbatches(64))), data)
    with pytest.raises(ValueError, match=r"expected \(n, 3\) batches"):
        next(IterableSource(factory, 100, 3).superbatches(40))


def test_device_superbatches_on_the_cpu_are_chunk_data():
    data = np.random.RandomState(3).rand(150, 3).astype(np.float32)
    got = list(pipeline.device_superbatches(ArraySource(data), 64, 32, "cpu"))
    assert [n for _, _, n in got] == [64, 64, 22]
    for (chunks, mask, n), s in zip(got, (0, 64, 128)):
        want_c, want_m, _ = chunk_data(data[s : s + 64], 32)
        assert chunks.device.type == "cpu" and chunks.dtype == torch.float32
        np.testing.assert_array_equal(chunks.numpy(), want_c)
        np.testing.assert_array_equal(mask.numpy(), want_m)


def test_epoch_timer_and_trace(tmp_path):
    import os

    from xpysom_dask_tpu_torch.utils.profiling import EpochTimer, annotate, trace

    timer = EpochTimer()
    assert timer.summary() == "no epochs recorded"
    som = _som(4, 4, 2, random_seed=0)
    data = np.random.RandomState(0).rand(64, 2).astype(np.float32)
    with trace(tmp_path):
        with annotate("epochs"):
            for t in range(3):
                som.train(data, 3, iter_beg=t, iter_end=t + 1)
                timer.tick()
    assert len(timer.durations) == 3 and timer.mean > 0
    assert "3 epochs" in timer.summary()
    assert [f for _, _, fs in os.walk(tmp_path) for f in fs], "the profiler wrote no trace"
    # as the pipeline's progress callback
    timer = EpochTimer()
    train_streaming(som._spec, som._weights, ArraySource(data), 2, device="cpu", progress=timer)
    assert len(timer.durations) == 2


def test_streaming_inference_matches_resident():
    data = np.random.RandomState(3).rand(5000, 6).astype(np.float32)
    som = _som(7, 6, 6, sigma=2.0, random_seed=2, n_parallel=256).train(data, 4)
    som._superbatch_rows = lambda: 1024  # several superbatches, a ragged last one
    src = ArraySource(data)
    np.testing.assert_array_equal(som.predict(src), som.predict(data))
    assert som.predict(src).dtype == np.int64
    assert som.quantization_error(src) == pytest.approx(som.quantization_error(data), rel=1e-6)
    assert som.topographic_error(src) == pytest.approx(som.topographic_error(data), rel=1e-6)


def test_streaming_inference_memmap(tmp_path):
    data = np.random.RandomState(4).rand(3000, 5).astype(np.float32)
    p = tmp_path / "d.f32"
    data.tofile(p)
    mm = np.memmap(p, dtype=np.float32, mode="r", shape=(3000, 5))
    som = _som(6, 6, 5, sigma=2.0, random_seed=1).train(data, 3)
    np.testing.assert_array_equal(som.predict(mm), som.predict(data))
    assert som.quantization_error(mm) == pytest.approx(som.quantization_error(data), rel=1e-6)


def test_streaming_activation_response_matches_resident():
    data = np.random.RandomState(7).rand(4000, 5).astype(np.float32)
    som = _som(6, 5, 5, sigma=2.0, random_seed=3, n_parallel=256).train(data, 3)
    som._superbatch_rows = lambda: 1024
    got = som.activation_response(ArraySource(data))
    np.testing.assert_array_equal(got, som.activation_response(data))
    assert got.sum() == len(data)


def test_streaming_matches_jax_inference():
    data = np.random.RandomState(5).rand(2000, 4).astype(np.float32)
    ref = JaxSom(5, 5, 4, sigma=2.0, random_seed=4).train(data, 3)
    ours = XPySom.from_numpy(np.asarray(ref._weights), sigma=2.0, device="cpu")
    ours._superbatch_rows = lambda: 512
    ref._superbatch_rows = lambda: 512
    src, ref_src = ArraySource(data), jax_pipeline.ArraySource(data)
    np.testing.assert_array_equal(ours.predict(src), ref.predict(ref_src))
    np.testing.assert_array_equal(ours.activation_response(src), ref.activation_response(ref_src))
    assert ours.quantization_error(src) == pytest.approx(ref.quantization_error(ref_src), rel=1e-5)
    assert ours.topographic_error(src) == pytest.approx(ref.topographic_error(ref_src), rel=1e-6)


def test_empty_source_contract():
    som = _som(4, 4, 3, random_seed=0)
    empty = ArraySource(np.zeros((0, 3), np.float32))
    assert som.predict(empty).shape == (0,) and som.predict(empty).dtype == np.int64
    for fn in (som.quantization_error, som.topographic_error):
        with pytest.warns(UserWarning, match="source yielded no rows"):
            assert np.isnan(fn(empty))
    np.testing.assert_array_equal(som.activation_response(empty), np.zeros((4, 4)))
    with pytest.raises(ValueError, match="empty data source"):
        som.train(empty, 1)


def test_streaming_rejects_wrong_width():
    som = _som(4, 4, 3, random_seed=0)
    wrong = ArraySource(np.zeros((10, 2), np.float32))
    for call in (lambda: som.train(wrong, 1), lambda: som.predict(wrong),
                 lambda: som.quantization_error(wrong)):
        with pytest.raises(ValueError, match="Received 2 features, expected 3"):
            call()


def test_streaming_verbose_prints_qe(capsys):
    data = np.random.RandomState(5).rand(200, 3).astype(np.float32)
    som = _som(4, 4, 3, random_seed=1, n_parallel=32)
    som.train(ArraySource(data), 2, verbose=True)
    assert "quantization error" in capsys.readouterr().out


def test_streaming_periodic_checkpoints_match_resident(tmp_path):
    data = np.random.RandomState(6).rand(300, 3).astype(np.float32)
    ckpt = tmp_path / "stream.npz"
    full = _som(4, 4, 3, random_seed=11, n_parallel=64).train(data, 5)
    ck = _som(4, 4, 3, random_seed=11, n_parallel=64)
    ck._superbatch_rows = lambda: 128
    ck.train(ArraySource(data), 5, checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_array_equal(_bits(ck._weights), _bits(full._weights))
    loaded = XPySom.load_checkpoint(ckpt, device="cpu")
    assert loaded._checkpoint_epoch == 5
    np.testing.assert_array_equal(loaded._weights, ck._weights)


def test_more_than_one_process_raises_item_8(monkeypatch, dataset):
    """Streaming across processes is ported (item 8): in a run of two
    processes, a model without a mesh streams on its own, with no
    collective, as one process does; the sharded source's defaults are the
    process group's rank and world size, or the mesh's when one is given.
    The runs across real processes are ``tests/test_torch_distributed.py``."""
    from xpysom_dask_tpu_torch.parallel.mesh import DataMesh

    f, data = dataset
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    streamed = _som(4, 4, 6, random_seed=0).train(ArraySource(data), 1)
    resident = _som(4, 4, 6, random_seed=0).train(data, 1)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))
    files = []
    for i in range(3):
        files.append(f.with_name(f"s{i}.f32"))
        data[i * 100 : (i + 1) * 100].tofile(files[-1])
    src = ShardedFileSource(files, 6)
    assert [str(p) for p in src.files] == [str(files[1])]
    src = ShardedFileSource(files, 6, mesh=DataMesh(None, 0, 2, torch.device("cpu")))
    assert [str(p) for p in src.files] == [str(files[0]), str(files[2])]


def test_sharded_file_source_round_robin_and_parity(tmp_path):
    rng = np.random.RandomState(4)
    shards = [rng.rand(n, 4).astype(np.float32) for n in (130, 70, 200)]
    files = []
    for i, s in enumerate(shards):
        files.append(tmp_path / f"shard{i}.f32")
        s.tofile(files[-1])
    src = ShardedFileSource(files, 4, process_id=0, num_processes=1)
    assert len(src) == 400 and src.dim == 4
    blocks = list(src.superbatches(64))
    assert [b.shape[0] for b in blocks[:-1]] == [64] * (len(blocks) - 1)
    np.testing.assert_array_equal(np.concatenate(blocks), np.concatenate(shards))

    resident = _som(5, 5, 4, random_seed=3, n_parallel=64).train(np.concatenate(shards), 3)
    streamed = _som(5, 5, 4, random_seed=3, n_parallel=64)
    streamed.train(ShardedFileSource(files, 4), 3)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))


def test_sharded_file_source_process_slicing(tmp_path):
    rng = np.random.RandomState(5)
    shards = [rng.rand(n, 3).astype(np.float32) for n in (40, 50, 60)]
    files = []
    for i, s in enumerate(shards):
        files.append(tmp_path / f"s{i}.f32")
        s.tofile(files[-1])
    a = ShardedFileSource(files, 3, process_id=0, num_processes=2)
    b = ShardedFileSource(files, 3, process_id=1, num_processes=2)
    assert [str(f) for f in a.files] == [str(files[0]), str(files[2])]
    assert [str(f) for f in b.files] == [str(files[1])]
    assert len(a) == 100 and len(b) == 50
    np.testing.assert_array_equal(np.concatenate(list(a.superbatches(32))),
                                  np.concatenate([shards[0], shards[2]]))
    c = ShardedFileSource(files[:1], 3, process_id=1, num_processes=2)
    assert len(c) == 0 and list(c.superbatches(32)) == []
    with pytest.raises(ValueError, match="whole number"):
        ShardedFileSource(files, 4, process_id=0, num_processes=1)
    with pytest.raises(ValueError, match="at least one"):
        ShardedFileSource([], 3)
    with pytest.raises(ValueError, match="out of range"):
        ShardedFileSource(files, 3, process_id=2, num_processes=2)


# -- the native loader (twins of tests/test_native_loader.py) ----------------


def test_native_loader_builds_into_the_build_directory(needs_native):
    from xpysom_dask_tpu_torch.utils import native

    path = native.library_path()
    assert path.is_file() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert not list((path.parents[2] / "xpysom_dask_tpu_torch" / "csrc").glob("*.so"))


def test_native_stream_matches_file(dataset, needs_native):
    f, data = dataset
    src = FileSource(f, 1000, 6)
    assert src._lib is not None
    np.testing.assert_array_equal(np.concatenate(list(src.superbatches(128))), data)


def test_native_stream_multiple_epochs(dataset, needs_native):
    f, data = dataset
    src = FileSource(f, 1000, 6)
    for _ in range(3):
        np.testing.assert_array_equal(np.concatenate(list(src.superbatches(333))), data)


def test_native_training_matches_resident(dataset, needs_native):
    f, data = dataset
    resident = _som(5, 5, 6, random_seed=1, n_parallel=64).train(data, 3)
    streamed = _som(5, 5, 6, random_seed=1, n_parallel=64)
    streamed._superbatch_rows = lambda: 256
    streamed.train(FileSource(f, 1000, 6), 3)
    np.testing.assert_array_equal(_bits(streamed._weights), _bits(resident._weights))


def test_filesource_memmap_fallback(dataset, monkeypatch):
    f, data = dataset
    src = FileSource(f, 1000, 6)
    monkeypatch.setattr(src, "_lib", None)
    np.testing.assert_array_equal(np.concatenate(list(src.superbatches(256))), data)


def test_native_short_file_raises(tmp_path, needs_native):
    p = tmp_path / "short.f32"
    np.random.RandomState(0).rand(10, 4).astype(np.float32).tofile(p)
    with pytest.raises(OSError, match="short file"):
        list(FileSource(str(p), 16, 4).superbatches(8))


def test_native_reset_protocol_recovers(tmp_path, needs_native):
    lib = load_chunkloader()
    p = tmp_path / "grow.f32"
    data = np.random.RandomState(1).rand(12, 4).astype(np.float32)
    data[:7].tofile(p)
    h = lib.xs_open(str(p).encode(), 12, 4, 5, 3)
    assert h
    try:
        rows = ctypes.c_int64(0)
        while True:
            lib.xs_acquire(h, ctypes.byref(rows))
            if rows.value <= 0:
                break
            lib.xs_release(h)
        assert rows.value == -1
        assert b"short file" in lib.xs_error(h)
        data.tofile(p)
        lib.xs_reset(h)
        got = []
        while True:
            ptr = lib.xs_acquire(h, ctypes.byref(rows))
            assert rows.value >= 0, "reset did not clear the error state"
            if rows.value == 0:
                break
            got.append(np.ctypeslib.as_array(ptr, shape=(rows.value, 4)).copy())
            lib.xs_release(h)
        np.testing.assert_array_equal(np.concatenate(got), data)
    finally:
        lib.xs_close(h)


def test_nonpositive_superbatch_rows_raise(dataset):
    f, data = dataset
    spec = SomSpec(4, 4, 6, 2.0, 1.0, 0.5, 0.01)
    w = np.zeros((4, 4, 6), np.float32)
    for bad in (0, -4):
        with pytest.raises(ValueError, match="superbatch rows"):
            next(FileSource(f, 1000, 6).superbatches(bad))
        with pytest.raises(ValueError, match="superbatch rows"):
            next(ArraySource(data).superbatches(bad))
        with pytest.raises(ValueError, match="superbatch rows"):
            train_streaming(spec, w, ArraySource(data), 1, superbatch_rows=bad, device="cpu")


def test_xs_open_rejects_invalid_geometry(dataset, needs_native):
    f, _ = dataset
    lib = load_chunkloader()
    path = str(f).encode()
    assert lib.xs_open(path, 1000, 6, 0, 2) is None
    assert lib.xs_open(path, 1000, 6, -4, 2) is None
    assert lib.xs_open(path, 1000, 0, 128, 2) is None
    assert lib.xs_open(path, -1, 6, 128, 2) is None
    # superbatch_rows * n_cols * 4 wrapping size_t
    assert lib.xs_open(path, 1000, 1 << 24, 1 << 40, 2) is None
    assert lib.xs_open(path, 1000, 1 << 31, 1 << 31, 2) is None
    h = lib.xs_open(path, 1000, 6, 128, 2)
    assert h is not None
    assert (lib.xs_error(h) or b"") == b""
    lib.xs_close(h)
