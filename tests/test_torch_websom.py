"""The port against the plain reference of the WEBSOM configuration
(``portbench/reference/som_separable.py``, loaded by path), on the CPU
with the kernels' plain versions, at the configuration's width D = 500 on
a small non-square map, so that a transposition of X and Y in the update's
factors, in TE's neighbour test or in a reshape shows. The reference
follows the port step by step, as the benchmark's check does: each
epoch's codebook from the port's codebook before it, then QE and TE of
the port's codebooks.

Tolerances, and why:

- ``step_gap`` (the largest unit gap over the median unit norm) 2e-6 and
  ``step_gap_median`` 1e-6: the port accumulates the statistics and
  applies the separable operator in float32 (about 17 rows a unit, 12
  and 10 factor terms), a few roundings of 2^-24 each, against float64;
  read 1.9e-7 to 3.0e-7 and 7.8e-8 to 1.05e-7 over six seeds. One winner
  that the search gives another unit moves a unit by about 1e-3 of a
  norm, and the bf16 search reads 1.8e-3 and more;
- ``qe_gap`` 1e-5, relative: the port's float32 sum of 2048 distances of
  about 9, whose rounding grows like sqrt(N) 2^-24, about 3e-6;
- ``te_gap`` 2 / 2048, a share of the rows: a near-tie between a row's
  second and third unit may resolve either way in a float32 search, for
  a row or two.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import profiling

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "portbench", "reference")
X, Y, D, N, EPOCHS = 12, 10, 500, 2048, 3
SOM = dict(sigma=min(X, Y) / 2, sigmaN=1, learning_rate=0.5, learning_rateN=0.01,
           decay_function="exponential", neighborhood_function="gaussian", std_coeff=0.5,
           topology="rectangular", activation_distance="euclidean")
LIMITS = {"step_gap": 2e-6, "step_gap_median": 1e-6, "qe_gap": 1e-5, "te_gap": 2 / N}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"websom_{name}", os.path.join(REFERENCE, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return _load("som_separable")


def _case(seed):
    rng = np.random.default_rng(seed)
    return rng.random((N, D), dtype=np.float32), rng.random((X, Y, D), dtype=np.float32)


def _numbers(ref, mode, seed):
    """The check's numbers for the port in ``mode`` against the reference,
    over every epoch of an EPOCHS-epoch job from a seeded codebook."""
    data, w0 = _case(seed)
    som = XPySom.from_numpy(w0, device="cpu", random_seed=seed, bmu_precision=mode, **SOM)
    cfg = ref.SomConfig.from_som_kwargs(dict(SOM, x=X, y=Y, input_len=D))
    rows = torch.from_numpy(data)
    gaps, medians = [], []
    for t in range(EPOCHS):
        before = torch.from_numpy(som.get_weights().copy()).double()
        som.train(data, EPOCHS, iter_beg=t, iter_end=t + 1)
        want = ref.step(cfg, rows, before, t, EPOCHS)
        unit = (torch.from_numpy(som.get_weights()).double() - want).reshape(-1, D).norm(dim=1)
        scale = want.reshape(-1, D).norm(dim=1).median()
        gaps.append(float(unit.max() / scale))
        medians.append(float(unit.median() / scale))
    numbers = {"step_gap": max(gaps), "step_gap_median": max(medians), "qe_gap": 0.0, "te_gap": 0.0}
    # the trained map, and the seeded one, where most rows' two nearest
    # units lie apart and TE reads the grid's orientation
    for w in (som.get_weights().copy(), w0):
        som.get_weights()[...] = w
        w64 = torch.from_numpy(w).double()
        qe_r = ref.quantization_error(rows, w64)
        numbers["qe_gap"] = max(numbers["qe_gap"], abs(som.quantization_error(data) - qe_r) / qe_r)
        te_r = ref.topographic_error(rows, w64, Y)
        numbers["te_gap"] = max(numbers["te_gap"], abs(som.topographic_error(data) - te_r))
    return numbers


@pytest.mark.parametrize("seed", range(4))
def test_the_port_follows_the_reference_at_d500_on_a_non_square_map(ref, seed):
    numbers = _numbers(ref, "packed", seed)
    assert all(numbers[k] <= lim for k, lim in LIMITS.items()), numbers


@pytest.mark.parametrize("seed", range(2))
def test_a_bf16_search_fails_a_tolerance(ref, seed):
    numbers = _numbers(ref, "bf16", seed)
    assert any(numbers[k] > lim for k, lim in LIMITS.items()), numbers


@pytest.mark.parametrize("shape", [(5, 4, 3), (7, 9, 6), (12, 10, 500)])
def test_the_separable_update_equals_the_einsum_update(ref, shape):
    som = _load("som")
    x, y, d = shape
    cfg = som.SomConfig(x=x, y=y, input_len=d, sigma=min(x, y) / 2, sigmaN=1.0, learning_rate=0.5,
                        learning_rateN=0.01)
    g = torch.Generator().manual_seed(x * 100 + y)
    w = torch.rand((x, y, d), generator=g, dtype=torch.float64)
    s = torch.rand((x * y, d), generator=g, dtype=torch.float64) * 7
    cnt = torch.randint(0, 3, (x * y,), generator=g).double()
    cnt[0] = 0
    for t in (0, 2):
        want = som.update(cfg, w, s * cnt[:, None], cnt, t, 3)
        got = ref.update(cfg, w, s * cnt[:, None], cnt, t, 3)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_a_traced_job_counts_the_codebooks_trips(tmp_path):
    """The codebook's upload counts its units (rows) and bytes, and the
    fetch that ends ``train`` its bytes; QE and TE fetch no codebook."""
    data, w0 = _case(7)
    data = data[:300]
    som = XPySom.from_numpy(w0, device="cpu", random_seed=7, n_parallel=128, **SOM)
    before = max((r["id"] for r in profiling.recorded()[0]), default=0)
    with profiling.trace(tmp_path):
        som.train(data, 2)
        som.quantization_error(data)
        som.topographic_error(data)
    recs = [r for r in profiling.recorded()[0] if r["id"] > before]
    calls = [r for r in recs if r["call"] == r["id"]]
    assert [r["name"] for r in calls] == [
        "xpysom.train", "xpysom.quantization_error", "xpysom.topographic_error"]
    codebook = X * Y * D * 4
    for root in calls:
        steps = [r for r in recs if r["call"] == root["id"] and r is not root]
        units = [r["counts"] for r in steps if r["name"] == "xpysom.upload" and "units" in r["counts"]]
        assert units == [{"bytes": codebook, "units": X * Y}]
        fetched = [r["counts"] for r in steps if r["name"] == "xpysom.fetch"]
        assert fetched == ([{"bytes": codebook}] if root["name"] == "xpysom.train" else [{}])
