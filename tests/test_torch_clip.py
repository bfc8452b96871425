"""The port under the cosine activation against the plain reference of the
CLIP configuration (``portbench/reference/som_cosine.py``, loaded by
path), on the CPU with the kernels' plain versions, at the configuration's
width D = 512 on a small non-square map with a ragged last chunk (2,125
rows in chunks of 512: the last holds 77). The reference follows the port
step by step, as the benchmark's check does: each epoch's codebook from
the port's codebook before it, then QE and TE of the port's codebooks.
Also: the feed ``search_feed`` picks at the cells' chunks, the spans and
counts a traced job records, and the harness's check failing the fault
``cosine_as_euclidean`` at a small size.

Tolerances, and why. Uniform rows on [0, 1) all point near one
direction, and the gaussian of sigma 3.5 pulls the 63 units towards their
mean in the first epoch, so from the second epoch a row's two most
similar units lie a few times the packed search's near-tie floor apart
(the median margin ~7 floors). The float32 packed search and the float64
reference then resolve a few rows (0-5 of 2,125 an epoch, read over six
seeds) to other units, each a near-tie (at most 0.045 of the floor), and
each such row moves its units by up to 1e-2 of a norm (about 34 rows a
unit):

- ``winner_floor`` (the largest gap, in x·w_hat, between a row's program
  winner and the most similar unit, over the packed search's stated floor
  ``2^-17 sum_d |x_d||w_hat_d|``) 1: the packed search's contract; read
  at most 0.045; the bf16 search passes it;
- ``step_gap_median`` 4e-3: read 6.4e-5 to 1.04e-3 (the flips' rows
  reach the median unit through the wide gaussian); the bf16 search reads
  1.4e-2 to 1.5e-2;
- ``step_gap`` 1.2e-2: read 2.6e-3 to 7.9e-3 (one flipped row's units);
  the bf16 search reads 1.7e-2 to 2.3e-2;
- ``qe_gap`` 1e-5, relative: QE is euclidean, the port's float32 sum of
  2,125 distances of about 5, whose rounding grows like sqrt(N) 2^-24;
  read at most 1.5e-7;
- ``te_gap`` 2 / 2,125, a share of the rows: TE is euclidean, and a
  near-tie between a row's second and third unit may resolve either way
  in a float32 search, for a row or two; read 0.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch import XPySom, core
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
from xpysom_dask_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(ROOT, "portbench")
X, Y, D, N, CHUNK, EPOCHS = 9, 7, 512, 2048 + 77, 512, 3
SOM = dict(sigma=min(X, Y) / 2, sigmaN=1, learning_rate=0.5, learning_rateN=0.01,
           decay_function="exponential", neighborhood_function="gaussian", std_coeff=0.5,
           topology="rectangular", activation_distance="cosine")
LIMITS = {"winner_floor": 1.0, "step_gap": 1.2e-2, "step_gap_median": 4e-3, "qe_gap": 1e-5,
          "te_gap": 2 / N}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the D = 512 products run beside the other test
    workers, whose threads would otherwise oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    path = os.path.join(PORTBENCH, "reference", "som_cosine.py")
    spec = importlib.util.spec_from_file_location("clip_som_cosine", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _case(seed):
    rng = np.random.default_rng(seed)
    return rng.random((N, D), dtype=np.float32), rng.random((X, Y, D), dtype=np.float32)


def _winner_floor(ref, som, data):
    """The largest gap between a row's program winner and its most similar
    unit (float64 x·w_hat) over the packed search's near-tie floor."""
    rows = torch.from_numpy(data).double()
    w_hat = ref.unit_directions(torch.from_numpy(som.get_weights()).reshape(-1, D))
    got = torch.from_numpy(som.predict(data))[:, None]
    sim = rows @ w_hat.T
    gap = sim.max(1).values - sim.gather(1, got)[:, 0]
    floor = 2.0**-17 * (rows.abs() @ w_hat.abs().T).gather(1, got)[:, 0]
    return float((gap / floor).max())


def _numbers(ref, mode, seed):
    """The check's numbers for the port in ``mode`` against the reference,
    over every epoch of an EPOCHS-epoch job from a seeded codebook."""
    data, w0 = _case(seed)
    som = XPySom.from_numpy(w0, device="cpu", random_seed=seed, bmu_precision=mode,
                            n_parallel=CHUNK, **SOM)
    cfg = ref.SomConfig.from_som_kwargs(dict(SOM, x=X, y=Y, input_len=D))
    rows = torch.from_numpy(data)
    gaps, medians, floors = [], [], []
    for t in range(EPOCHS):
        floors.append(_winner_floor(ref, som, data))
        before = torch.from_numpy(som.get_weights().copy()).double()
        som.train(data, EPOCHS, iter_beg=t, iter_end=t + 1)
        want = ref.step(cfg, rows, before, t, EPOCHS)
        unit = (torch.from_numpy(som.get_weights()).double() - want).reshape(-1, D).norm(dim=1)
        scale = want.reshape(-1, D).norm(dim=1).median()
        gaps.append(float(unit.max() / scale))
        medians.append(float(unit.median() / scale))
    numbers = {"winner_floor": max(floors), "step_gap": max(gaps), "step_gap_median": max(medians),
               "qe_gap": 0.0, "te_gap": 0.0}
    for w in (som.get_weights().copy(), w0):
        som.get_weights()[...] = w
        w64 = torch.from_numpy(w).double()
        qe_r = ref.quantization_error(rows, w64)
        numbers["qe_gap"] = max(numbers["qe_gap"], abs(som.quantization_error(data) - qe_r) / qe_r)
        te_r = ref.topographic_error(rows, w64, Y)
        numbers["te_gap"] = max(numbers["te_gap"], abs(som.topographic_error(data) - te_r))
    return numbers


@pytest.mark.parametrize("seed", range(4))
def test_the_port_follows_the_cosine_reference_at_d512_with_a_ragged_chunk(ref, seed):
    assert -(-N // CHUNK) == 5 and N % CHUNK == 77
    numbers = _numbers(ref, "packed", seed)
    assert all(numbers[k] <= lim for k, lim in LIMITS.items()), numbers


@pytest.mark.parametrize("seed", range(2))
def test_a_bf16_cosine_search_fails_a_tolerance(ref, seed):
    numbers = _numbers(ref, "bf16", seed)
    assert any(numbers[k] > lim for k, lim in LIMITS.items()), numbers


def test_the_reference_search_is_the_first_greatest_cosine(ref):
    """Against upstream's formula ``1 - x·w / (|x||w|)``: the first index
    of its least, duplicated units and a zero unit included."""
    g = torch.Generator().manual_seed(5)
    rows = torch.rand((300, 16), generator=g, dtype=torch.float64)
    w = torch.rand((12, 16), generator=g, dtype=torch.float64)
    w[7] = w[3]  # an exact tie: the first index wins
    w[9] = 2.0 * w[1]  # the same direction, twice the length: an exact tie
    w[11] = 0.0
    cos = 1 - (rows @ w.T) / (rows.norm(dim=1)[:, None] * w.norm(dim=1)[None, :])
    want = torch.argmin(torch.nan_to_num(cos, nan=2.0), dim=1)
    got = ref.winners(rows, w, "cosine")
    assert torch.equal(got, want)
    assert not (got == 7).any() and not (got == 9).any() and not (got == 11).any()
    gaps = ref.winner_gaps(rows, w, got, "cosine")
    assert float(gaps.abs().max()) == 0.0
    assert ref.unit_directions(w)[11].abs().sum() == 0


@pytest.mark.parametrize("cell,n,k,xy,feed", [
    ("embedding-fit-d512", 16384, 3 * 512 + 3, 128 * 128, kb.FEED_STREAMED),
    ("seismic-fit", 16384, 3 * 64 + 3, 128 * 128, kb.FEED_REGISTERS),
    ("websom-fit", 16384, 3 * 500 + 3, 1044 * 960, kb.FEED_PAIRS),
])
def test_search_feed_routes_each_cells_chunk(cell, n, k, xy, feed):
    assert kb.search_feed(n, k, xy) == feed
    if cell == "embedding-fit-d512":
        # the laid-out codebook, 97% of L2: A streamed, not pairs
        laid = -(-xy // kb.K1_BN) * kb.K1_BN * 1552 * 2
        assert laid == 50_855_936 and laid <= kb.L2_BYTES < laid * 1.04


@pytest.mark.parametrize("mode,depth", [("packed", 1552), ("bf16", 528), ("margin", 528)])
def test_the_cosine_codebook_names_its_depth_and_feed(mode, depth):
    w = torch.rand((128 * 128, D), generator=torch.Generator().manual_seed(1))
    assert kb.cosine_codebook(w, mode).search_feed(16384) == (depth, kb.FEED_STREAMED)
    assert kb.PackedCodebook(w, "highest").search_feed(16384) is None


@pytest.fixture
def counted_searches(monkeypatch):
    """``core._bmu_chunk`` counting a launch of K1 on the feed its chunk
    would take on the card (the plain versions launch nothing), and every
    counter from 0."""
    for fn in kernels.KERNELS.values():
        monkeypatch.setattr(fn, "launches", 0)
    for name in kernels.FED:
        for feed in kernels.FEEDS:
            monkeypatch.setattr(kernels.KERNELS[name], feed, 0)
    plain = core._bmu_chunk

    def bmu_chunk(spec, search, x):
        k16, feed = search.search_feed(x.shape[0])
        kb._count_feed(kb.bmu_argmin, feed)
        return plain(spec, search, x)

    monkeypatch.setattr(core, "_bmu_chunk", bmu_chunk)


def test_a_traced_job_records_the_codebooks_and_the_calls_searches(tmp_path, counted_searches):
    data, w0 = _case(3)
    som = XPySom.from_numpy(w0, device="cpu", random_seed=3, n_parallel=CHUNK, **SOM)
    before = max((r["id"] for r in profiling.recorded()[0]), default=0)
    with profiling.trace(tmp_path):
        som.train(data, 2)
        som.quantization_error(data)
        som.topographic_error(data)
    recs = [r for r in profiling.recorded()[0] if r["id"] > before]
    calls = [r for r in recs if r["call"] == r["id"]]
    assert [r["name"] for r in calls] == [
        "xpysom.train", "xpysom.quantization_error", "xpysom.topographic_error"]
    chunks = -(-N // CHUNK)
    # train: one codebook an epoch, in the epoch's span; QE and TE: one
    codebooks = {"xpysom.train": 2, "xpysom.quantization_error": 1, "xpysom.topographic_error": 1}
    # K1 counted a chunk in training and in QE (TE's K2 is not routed
    # through _bmu_chunk, so it counts none here)
    searches = {"xpysom.train": 2 * chunks, "xpysom.quantization_error": chunks,
                "xpysom.topographic_error": 0}
    for root in calls:
        steps = [r for r in recs if r["call"] == root["id"] and r is not root]
        built = [r for r in steps if r["name"] == "xpysom.codebook"]
        assert len(built) == codebooks[root["name"]]
        # every search at D = 512 streams A: the packed depth 3 * 512 + 3, padded
        assert all(r["counts"] == {"units": X * Y, "depth": 1552, "feed": kb.FEED_STREAMED}
                   for r in built)
        assert root["counts"] == {"rows": N, "searches": searches[root["name"]],
                                  "streamed_searches": searches[root["name"]]}
    epochs = [r for r in recs if r["name"] == "xpysom.epoch"]
    train_books = [r for r in recs if r["name"] == "xpysom.codebook" and r["call"] == calls[0]["id"]]
    for epoch, book in zip(epochs, train_books):
        assert epoch["t0"] <= book["t0"] <= book["t1"] <= epoch["t1"]
    # the benchmark's reader of these counts: every search streamed A
    metrics = os.path.join(PORTBENCH, "metrics")
    sys.path.insert(0, metrics)
    try:
        spec = importlib.util.spec_from_file_location(
            "clip_streamed_search_share", os.path.join(metrics, "streamed_search_share.py"))
        reader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reader)
        assert reader.read(None, "train") == reader.read(None, "score") == 100.0
    finally:
        sys.path.remove(metrics)


def _harness_run(tmp_path, plant=None):
    """A whole run of ``embedding-fit-d512`` through the harness on the CPU
    at a small size (a 16 x 16 map of 16 features on 8,269 rows), in a
    process of its own, the fault ``plant`` planted first."""
    sys.path.insert(0, PORTBENCH)
    try:
        from harness import launch, manifest
    finally:
        sys.path.remove(PORTBENCH)
    spec = manifest.run_spec(ROOT, "embedding-fit-d512", 2**31 + 2301, 0.05, False)
    spec.update(device="cpu", started=time.time(), tmpdir=str(tmp_path))
    spec["config"]["n_samples"] = 8192 + 77
    spec["config"]["som"].update(x=16, y=16, input_len=16, sigma=8)
    if plant:
        spec["plant"] = os.path.join(PORTBENCH, "tests", "faults", plant)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(PORTBENCH, "harness", "rank.py"), str(path),
                          "0"], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith(launch.RESULT_MARK)][-1]
    return json.loads(line[len(launch.RESULT_MARK):])["result"]


@pytest.mark.parametrize("plant", [None, "cosine_as_euclidean.py"])
def test_the_check_fails_a_cosine_search_by_euclidean_distance(tmp_path, plant):
    result = _harness_run(tmp_path, plant)
    assert result["correct"] == (plant is None), result["checks"]
    assert result["failed"] == 0
