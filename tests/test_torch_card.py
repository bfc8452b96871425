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

The streaming pipeline on the card (the feed's pinned ring on a side
stream): streamed training, ``predict`` and ``activation_response`` of
the flagship map equal the resident ones bit for bit (2^18 rows and a
ragged 5000-row tail, superbatches of 2^16); and checkpoint resume
equals the uninterrupted run bit for bit. Streamed ``predict`` and
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
import), and ``epoch_anatomy`` launches each stage's kernels exactly.

K1 and K2 give the same bits on each of their feeds (A streamed, pairs of
row blocks sharing each codebook chunk, A in registers) on 1, 2, 3 and
129 row blocks, and the routed launches count the feed ``search_feed``
picks. On the two deep feeds a tile is 256 codebook rows (two laid-out
128-row tiles a stage): past the register depth they agree with each
other and with K10's 128-wide search bit for bit, on an odd count of
laid-out tiles, last depth chunks of 32 and 16 and a pair of one row
block; planted ties on either side of a tile's 128-row seam and across
256-row tiles go to the first index; and ``.wide`` counts exactly the
launches past the register depth.

The resident and the streamed feed on the card: the pinned ring is made
once and reused by the next call, and the chunks and mask each feed makes
through the ring (rows not a multiple of its slice, and a request under
one slice) equal the CPU feed's bit for bit."""

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


# (samples, nodes, D): 1, 2, 3 and 129 row blocks of 128, at 129 and 16384
# nodes (K = 208: A in registers, four chunks deep) and at a reduced
# WEBSOM width (K = 1504: A streamed or pairs); A in registers one, two
# and three chunks deep (K = 32, 96, 160)
FEED_FIXTURES = [(n, xy, d) for d, xys in ((64, (129, 16384)), (500, (3000,))) for xy in xys
                 for n in (64, 129, 384, 16384 + 64)] + [(384, 3000, 5), (384, 3000, 30),
                                                        (16384 + 64, 16384, 50)]


def _bits(ts):
    return [t.view(torch.int32) for t in ts]


@pytest.mark.parametrize("n,xy,d", FEED_FIXTURES)
def test_k1_and_k2_feeds_equal_bitwise(card, n, xy, d):
    """K1 and K2 on every feed (A streamed; pairs of row blocks sharing
    each codebook chunk, over one row block the pair's second block past
    the rows; A in registers up to REGISTER_K) give the same bits, the
    routed searches take ``search_feed``'s feed, and the counters count
    it."""
    rng = np.random.RandomState(n + xy + d)
    x = torch.from_numpy(rng.rand(n, d).astype(np.float32)).to(card)
    cb = kb.PackedCodebook(torch.from_numpy((rng.rand(xy, d) * 2 - 1).astype(np.float32)).to(card))
    k, w_laid = 3 * d + 3, cb.laid()[0]
    a_laid = kb.lay_out_samples(x, cb.center, "packed")
    feeds = [kb.FEED_STREAMED, kb.FEED_PAIRS] + [kb.FEED_REGISTERS] * (k <= kb.REGISTER_K)
    for entry, outs in (("xps_gemm_argmin", 2), ("xps_gemm_top2", 4)):
        got = [kb._gemm_sm90(entry, (a_laid, w_laid), n, k, xy, f, outs=outs) for f in feeds]
        assert all(all(map(torch.equal, _bits(g), _bits(got[0]))) for g in got[1:]), entry
    before = kernels.launch_counts()
    routed = cb.top2(x)
    idx, val = cb.argmin(x)
    after = kernels.launch_counts()
    assert all(map(torch.equal, _bits((idx, val)), _bits(got[0][:2])))
    assert all(map(torch.equal, _bits(routed), _bits(got[0])))
    feed = kb.search_feed(n, k, xy)
    assert feed == (kb.FEED_REGISTERS if d < 500 else kb.FEED_STREAMED)
    for name in kernels.FED:
        assert after[name] - before[name] == 1
        assert after[f"{name}.registers"] - before[f"{name}.registers"] == int(d < 500)
        assert after[f"{name}.paired"] == before[f"{name}.paired"]
        assert after[f"{name}.wide"] - before[f"{name}.wide"] == int(d == 500)
        assert after[f"{name}.streamed"] - before[f"{name}.streamed"] == int(d == 500)


# (samples, nodes, D) past the register depth, on the 256-wide tiles: 3
# laid-out tiles (the last wide tile has one) at K = 1504 (a last depth
# chunk of 32) on 1, 2 and 3 row blocks, and at K = 272 (a last chunk of
# 16); 7,831 laid-out tiles, a codebook beyond L2, on 2 row blocks (pairs);
# packed D = 512 (K = 1552) on 129 row blocks
WIDE_FIXTURES = [(64, 300, 500), (129, 300, 500), (384, 300, 500), (384, 300, 85),
                 (256, 7830 * 128 + 128, 500), (16384 + 64, 16384, 512)]


@pytest.mark.parametrize("n,xy,d", WIDE_FIXTURES)
def test_wide_tiles_equal_on_both_deep_feeds_and_k10s_search(card, n, xy, d):
    """K1 and K2 on 256-wide tiles, A streamed and as pairs (over one row
    block the pair's second block past the rows), give the same bits; K1's
    winners are those of K10's search (A streamed on 128-wide tiles); the
    routed searches take ``search_feed``'s feed and count ``.wide``."""
    rng = np.random.RandomState(n + xy + d)
    x = torch.from_numpy(rng.rand(n, d).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.rand(xy, d) * 2 - 1).astype(np.float32)).to(card)
    cb = kb.PackedCodebook(w, "packed", center=False)
    k, w_laid = 3 * d + 3, cb.laid()[0]
    assert -(-k // 16) * 16 > kb.REGISTER_K
    a_laid = kb.lay_out_samples(x, cb.center, "packed")
    for entry, outs in (("xps_gemm_argmin", 2), ("xps_gemm_top2", 4)):
        got = [kb._gemm_sm90(entry, (a_laid, w_laid), n, k, xy, f, outs=outs)
               for f in (kb.FEED_STREAMED, kb.FEED_PAIRS)]
        assert all(map(torch.equal, _bits(got[1]), _bits(got[0]))), entry
    before = kernels.launch_counts()
    idx, val = cb.argmin(x)
    top2 = cb.top2(x)
    after = kernels.launch_counts()
    assert all(map(torch.equal, _bits((idx, val)), _bits(top2[:2])))
    assert all(map(torch.equal, _bits(top2), _bits(got[0])))
    feed = kb.search_feed(n, k, xy)
    for name in kernels.FED:
        moved = {key: after[key] - before[key] for key in after
                 if key.startswith(name + ".") and after[key] != before[key]}
        assert moved == {f"{name}.wide": 1, **({f"{name}.paired": 1} if feed == kb.FEED_PAIRS
                                               else {f"{name}.streamed": 1})}
    i_f, _ = kf.bmu_stats_fused(x, cb, torch.ones(n, device=card))
    assert torch.equal(i_f, idx), "K10's winners (128-wide tiles) are K1's"


@pytest.mark.parametrize("d", [50, 100])
@pytest.mark.parametrize("n", [4, 260, 16384 + 4])
def test_ties_at_the_wide_tiles_seams_go_to_the_first_index(card, n, d):
    """Exact ties (identical codebook rows) on either side of the 128-row
    seam inside a 256-wide tile (127, 128), across two wide tiles (255,
    256) and two tiles apart (300, 600): on every feed the depth takes
    (D = 50: K = 160, A in registers on 128-wide tiles too; D = 100:
    K = 304) K1 takes the first and K2 the second as its runner-up, and
    the zero rows take units 0 and 1."""
    w = np.zeros((700, d), np.float32)
    for i, v in ((127, 5), (128, 5), (255, 3), (256, 3), (300, 7), (600, 7)):
        w[i] = v
    x = np.tile(np.array([0, 5, 3, 7], np.float32)[:, None] * np.ones(d, np.float32),
                (n // 4, 1))
    cb = kb.PackedCodebook(torch.from_numpy(w).to(card))
    k = 3 * d + 3
    a_laid = kb.lay_out_samples(torch.from_numpy(x).to(card), cb.center, "packed")
    feeds = [kb.FEED_STREAMED, kb.FEED_PAIRS] + [kb.FEED_REGISTERS] * (k <= kb.REGISTER_K)
    first, second = [0, 127, 255, 300] * (n // 4), [1, 128, 256, 600] * (n // 4)
    for feed in feeds:
        i1, _ = kb._gemm_sm90("xps_gemm_argmin", (a_laid, cb.laid()[0]), n, k, 700, feed)
        j1, _, j2, _ = kb._gemm_sm90("xps_gemm_top2", (a_laid, cb.laid()[0]), n, k, 700, feed,
                                     outs=4)
        assert i1.tolist() == first and j1.tolist() == first, feed
        assert j2.tolist() == second, feed


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
    superbatches' pinned staging buffers (the feed's ring is made once a
    process) however many superbatches it streams: from N to 4N rows
    neither the card's peak nor the pinned bytes handed out grow by one
    superbatch's winners."""
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
    # K1 at K = 208 holds A in registers on every launch
    regs = {"bmu_argmin.registers": runs} if search == "bmu_argmin" else {}
    assert out["bmu_launches"] == {search: runs, **regs}
    assert out["stats_launches"] == out["epoch_launches"] == {search: runs, "scatter_stats": runs,
                                                              **regs}
    assert all(np.isfinite(out[k]) for k in ("bmu_ms", "stats_ms", "epoch_ms"))
    np.testing.assert_array_equal(som.get_weights().view(np.int64), w0.view(np.int64))


def _resident_feed(data, device):
    from xpysom_dask_tpu_torch.models.som import _chunks_on

    return [_chunks_on(data, 1024, None, device)]


def _streamed_feed(data, device):
    from xpysom_dask_tpu_torch.parallel.pipeline import device_superbatches

    return list(device_superbatches(ArraySource(data), 9 * 1024, 1024, device))


@pytest.mark.parametrize("feed", [_resident_feed, _streamed_feed], ids=["resident", "streamed"])
def test_resident_feed_reuses_its_ring_and_equals_the_cpu_feed(card, monkeypatch, feed):
    from xpysom_dask_tpu_torch.parallel import pipeline

    d = 64
    monkeypatch.setattr(pipeline, "STAGE_BYTES", 4096 * d * 4)  # 4096 rows a slot
    monkeypatch.setattr(pipeline, "_RINGS", {})
    rng = np.random.RandomState(0)
    calls = [rng.rand(5 * 4096 + 123, d).astype(np.float32),  # six slices, the last ragged
             rng.rand(1000, d).astype(np.float32)]  # a request under one slice
    slots = None
    for data in calls:
        got = feed(data, card)
        (ring,) = pipeline._RINGS.values()
        if slots is None:
            slots = [s.data_ptr() for s in ring.slots]
            assert all(s.is_pinned() and s.numel() == 4096 * d for s in ring.slots)
        assert [s.data_ptr() for s in ring.slots] == slots  # the same pinned memory
        want = feed(data, torch.device("cpu"))
        assert len(got) == len(want)
        for (chunks, mask, n), (want_chunks, want_mask, want_n) in zip(got, want):
            assert n == want_n and chunks.device.type == mask.device.type == "cuda"
            assert torch.equal(chunks.cpu().view(torch.int32), want_chunks.view(torch.int32))
            assert torch.equal(mask.cpu().view(torch.int32), want_mask.view(torch.int32))
