"""Tests of the port that need a CUDA card (marker ``cuda``; each skips
where ``torch.cuda.is_available()`` is false, as on a CPU-only machine).
Run them on the card with ``python -m pytest -m cuda tests/test_torch_card.py``.

K10 (``bmu_stats_fused``, one cooperative launch) against the composition
it fuses, K1 (``PackedCodebook.argmin``, the same laid-out operands) then
K9 (``scatter_stats``): winners and statistics bit for bit, and a second
launch the same. The fixtures reach each loop of the kernel: the flagship
chunk (128 row blocks on 132 SMs, one node range per group of 256
threads), a ragged chunk, n = 65536 (512 row blocks: the persistent search
wraps, on a fresh ring per row block), 200 x 100 and 200 x 200 nodes (the
latter 313 ranges of 128 nodes: some groups take two) and D = 200 (two
column passes, 373 ranges of 44 nodes; K = 603).

The streaming pipeline on the card (pinned buffers and a copy stream):
streamed training, ``predict`` and ``activation_response`` of the
flagship map equal the resident ones bit for bit (2^18 rows and a ragged
5000-row tail, superbatches of 2^16); and checkpoint resume equals the
uninterrupted run bit for bit. Streamed ``predict`` and
``activation_response`` keep one superbatch's winners on the card and
two in pinned host memory: neither peak grows from N rows to 4N.

``SomPopulation`` on the card: a serial sweep equals training each member
alone bit for bit, and a streamed ``'fused'`` sweep equals the resident
one.

Data parallel on the card: a world of one process on NCCL
(``mesh='auto'``) trains two flagship epochs bit for bit as ``mesh=None``
does, and scores alike; so does a (1, 1) (data, model) grid on NCCL
(codebook sharding at one shard).

The sklearn adapter with no ``device`` (the card) trains the flagship bit
for bit as a bare ``XPySom`` (skipped where scikit-learn does not
import), and ``epoch_anatomy`` launches each stage's kernels exactly."""

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch import SomPopulation, XPySom
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.parallel.pipeline import ArraySource

from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
from xpysom_dask_tpu_torch.ops.kernels import fused_stats as kf
from xpysom_dask_tpu_torch.ops.kernels import stats as ks

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


# name: (samples, nodes, D)
FIXTURES = {
    "uniform flagship chunk": (16384, 16384, 64),
    "ragged": (1000, 91, 5),
    "n = 65536": (65536, 16384, 64),
    "xy = 20000": (16384, 20000, 64),
    "xy = 40000": (16384, 40000, 64),
    "D = 200": (16384, 16384, 200),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_k10_equals_k1_then_k9_bitwise(card, name):
    n, xy, d = FIXTURES[name]
    rng = np.random.RandomState(len(name))
    x = torch.from_numpy(rng.rand(n, d).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.rand(xy, d) * 2 - 1).astype(np.float32)).to(card)
    m = torch.from_numpy((rng.rand(n) > 0.05).astype(np.float32)).to(card)
    cb = kb.PackedCodebook(w, "packed", center=False)
    before = kf.bmu_stats_fused.launches
    i_f, acc = kf.bmu_stats_fused(x, cb, m)
    i_f2, acc2 = kf.bmu_stats_fused(x, cb, m)
    assert kf.bmu_stats_fused.launches == before + 2
    i_1, _ = cb.argmin(x)
    acc9 = ks.scatter_stats(x, m, i_1, xy)
    torch.cuda.synchronize()
    assert acc.shape == (xy, d + 1)
    assert torch.equal(i_f, i_1), "K10's winners are K1's"
    assert torch.equal(acc.view(torch.int32), acc9.view(torch.int32)), "K10's statistics are K9's"
    assert torch.equal(i_f2, i_f) and torch.equal(acc2.view(torch.int32), acc.view(torch.int32))
    assert float(acc[:, -1].sum()) == float(m.sum())


KW = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)


def test_streamed_equals_resident_bitwise(card):
    data = np.random.RandomState(1).rand((1 << 18) + 5000, 64).astype(np.float32)
    kernels.reset_launch_counts()
    streamed = XPySom(128, 128, 64, **KW)
    streamed._superbatch_rows = lambda: 1 << 16
    streamed.train(ArraySource(data), 2)
    win = streamed.predict(ArraySource(data))
    hits = streamed.activation_response(ArraySource(data))
    counts = kernels.launch_counts()
    resident = XPySom(128, 128, 64, **KW).train(data, 2)
    assert np.array_equal(streamed.get_weights().view(np.int32),
                          resident.get_weights().view(np.int32))
    assert np.array_equal(win, resident.predict(data))
    assert np.array_equal(hits, resident.activation_response(data))
    chunks = -(-len(data) // 16384)
    assert counts["bmu_argmin"] >= 4 * chunks and counts["scatter_stats"] >= 2 * chunks


def test_checkpoint_resume_bitwise(card, tmp_path):
    data = np.random.RandomState(2).rand(1 << 16, 16).astype(np.float32)
    kw = dict(sigma=8, random_seed=3)
    full = XPySom(32, 32, 16, **kw).train(data, 4)
    cut = XPySom(32, 32, 16, **kw)
    cut.train(data, 4, iter_end=2, checkpoint_path=tmp_path / "ck", checkpoint_every=2)
    resumed = XPySom.load_checkpoint(tmp_path / "ck")
    assert resumed._checkpoint_epoch == 2 and resumed._device.type == "cuda"
    resumed.train(data, 4, iter_beg=resumed._checkpoint_epoch)
    assert np.array_equal(resumed.get_weights().view(np.int32), full.get_weights().view(np.int32))


def test_streamed_scoring_memory_does_not_grow_with_rows(card):
    """The card holds one superbatch's winners, and a call hands out two
    superbatches' pinned staging buffers (and the feed's two) however many
    superbatches it streams: from N to 4N rows neither the card's peak
    nor the pinned bytes handed out grow by one superbatch's winners."""
    rows = 1 << 15
    som = XPySom(32, 32, 16, sigma=8, random_seed=3)
    som._superbatch_rows = lambda: rows
    rng = np.random.RandomState(4)
    peaks, pinned = {}, {}
    for n in (1 << 18, 1 << 20):
        src = ArraySource(rng.rand(n, 16).astype(np.float32))
        for name in ("predict", "activation_response"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            handed = torch.cuda.host_memory_stats()["active_bytes.allocated"]
            out = getattr(som, name)(src)
            torch.cuda.synchronize()
            peaks[name, n] = torch.cuda.max_memory_allocated()
            pinned[name, n] = torch.cuda.host_memory_stats()["active_bytes.allocated"] - handed
            assert (len(out) if name == "predict" else out.sum()) == n
    for name in ("predict", "activation_response"):
        grew = peaks[name, 1 << 20] - peaks[name, 1 << 18]
        assert grew < 4 * rows, f"{name}: peak card memory grew by {grew} bytes"
        grew = pinned[name, 1 << 20] - pinned[name, 1 << 18]
        assert grew < 4 * rows, f"{name}: pinned host bytes handed out grew by {grew} bytes"


POP_KW = dict(sigma=[3.0, 2.0, 1.5, 1.0], learning_rate=[0.5, 0.4, 0.3, 0.6], random_seed=5)


def test_population_serial_equals_lone_training_bitwise(card):
    data = np.random.RandomState(6).rand(1 << 16, 16).astype(np.float32)
    pop = SomPopulation(4, 24, 24, 16, **POP_KW).train(data, 2, strategy="serial")
    for i in range(4):
        lone = XPySom(24, 24, 16, sigma=POP_KW["sigma"][i],
                      learning_rate=POP_KW["learning_rate"][i], random_seed=5 + i).train(data, 2)
        assert np.array_equal(pop.member(i).get_weights().view(np.int32),
                              lone.get_weights().view(np.int32))


def test_population_streamed_fused_equals_resident_bitwise(card):
    data = np.random.RandomState(7).rand(1 << 16, 16).astype(np.float32)
    kernels.reset_launch_counts()
    streamed = SomPopulation(4, 24, 24, 16, **POP_KW)
    streamed._superbatch_rows = lambda: 1 << 14
    streamed.train(ArraySource(data), 2, strategy="fused")
    counts = kernels.launch_counts()
    resident = SomPopulation(4, 24, 24, 16, **POP_KW).train(data, 2, strategy="fused")
    assert np.array_equal(streamed.weights.view(np.int32), resident.weights.view(np.int32))
    assert counts["bmu_argmin"] == counts["scatter_stats"] == 2 * 4 * 4


def test_world_of_one_on_nccl_is_the_single_device_path(card, tmp_path):
    import torch.distributed as dist

    from xpysom_dask_tpu_torch.parallel import initialize_multihost

    data = np.random.RandomState(0).rand(1 << 19, 64).astype(np.float32)
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        meshed = XPySom(128, 128, 64, **kw, mesh="auto").train(data, 2)
        assert meshed._mesh.world == 1 and meshed._device.type == "cuda"
        single = XPySom(128, 128, 64, **kw).train(data, 2)
        np.testing.assert_array_equal(meshed.get_weights().view(np.int32),
                                      single.get_weights().view(np.int32))
        np.testing.assert_array_equal(meshed.predict(data), single.predict(data))
        assert meshed.quantization_error(data) == single.quantization_error(data)
        assert meshed.topographic_error(data) == single.topographic_error(data)
    finally:
        dist.destroy_process_group()


def test_one_by_one_grid_on_nccl_is_the_single_device_path(card, tmp_path):
    import torch.distributed as dist

    from xpysom_dask_tpu_torch.parallel import GridMesh, initialize_multihost, make_grid_mesh

    data = np.random.RandomState(0).rand(1 << 19, 64).astype(np.float32)
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        grid = XPySom(128, 128, 64, **kw, mesh=make_grid_mesh(1, 1)).train(data, 2)
        assert isinstance(grid._mesh, GridMesh) and grid._device.type == "cuda"
        single = XPySom(128, 128, 64, **kw).train(data, 2)
        np.testing.assert_array_equal(grid.get_weights().view(np.int32),
                                      single.get_weights().view(np.int32))
        np.testing.assert_array_equal(grid.predict(data), single.predict(data))
        assert grid.quantization_error(data) == single.quantization_error(data)
        assert grid.topographic_error(data) == single.topographic_error(data)
    finally:
        dist.destroy_process_group()


FLAGSHIP_KW = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)


def test_adapter_trains_the_flagship_bitwise_as_xpysom(card):
    pytest.importorskip("sklearn")
    from xpysom_dask_tpu_torch.sklearn import SomClusterer

    data = np.random.RandomState(0).rand(1 << 19, 64).astype(np.float32)
    est = SomClusterer(128, 128, num_epochs=2, n_parallel=16384, **FLAGSHIP_KW).fit(data)
    assert est.som_._device.type == "cuda"
    som = XPySom(128, 128, 64, n_parallel=16384, **FLAGSHIP_KW).train(data, 2)
    np.testing.assert_array_equal(est.cluster_centers_.view(np.int64),
                                  som.get_weights().reshape(-1, 64).view(np.int64))
    np.testing.assert_array_equal(est.labels_, som.predict(data))
    assert est.score(data) == -som.quantization_error(data)


@pytest.mark.parametrize("activation,search", [("euclidean", "bmu_argmin"),
                                               ("manhattan", "bmu_manhattan")])
def test_epoch_anatomy_launches_each_stage_its_kernels(card, activation, search):
    """Each stage launches exactly its kernels once a chunk a run: the
    search alone in the BMU stage, with K9 in the statistics and epoch
    stages; the weights stay as they were."""
    from xpysom_dask_tpu_torch.utils.profiling import epoch_anatomy

    data = np.random.RandomState(0).rand(1 << 17, 64).astype(np.float32)
    som = XPySom(128, 128, 64, n_parallel=16384, activation_distance=activation,
                 **FLAGSHIP_KW)
    w0 = som.get_weights().copy()
    out = epoch_anatomy(som, data, lo=1, hi=2, reps=1)
    runs = (1 + 1) * (1 + 2) * 8  # (reps + warm-up) x (lo + hi) x chunks
    assert out["bmu_launches"] == {search: runs}
    assert out["stats_launches"] == out["epoch_launches"] == {search: runs, "scatter_stats": runs}
    assert all(np.isfinite(out[k]) for k in ("bmu_ms", "stats_ms", "epoch_ms"))
    np.testing.assert_array_equal(som.get_weights().view(np.int64), w0.view(np.int64))
