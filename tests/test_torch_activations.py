"""The PyTorch port's non-euclidean activations and the 'highest' mode
against the JAX package and the float64 golden model, on the CPU at small
sizes: the distance registry, the dispatch gate, the whole train → winner
→ QE → TE path, and the model-level rules (precision resolution, chunk
sizing, QE under the spec's mode). Inputs are made with numpy from fixed
seeds and handed to every package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu import core as jcore
from xpysom_dask_tpu.models.golden import GoldenSom
from xpysom_dask_tpu.ops import distances as jdist
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch import core as tcore
from xpysom_dask_tpu_torch.ops import distances as tdist
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke
from xpysom_dask_tpu_torch.utils.hw import default_n_parallel

# (activation, kwargs, bmu_precision) of the whole-path checks
CONFIGS = [
    ("cosine", {}, None),
    ("manhattan", {}, None),
    ("norm_p", {"p": 3}, None),
    ("norm_p", {"p": 1.5}, None),
    ("norm_p", {"p": 4}, None),
    ("euclidean", {}, "highest"),
]
_IDS = ["cosine", "manhattan", "norm_p3", "norm_p1.5", "norm_p4", "highest"]


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("euclidean", {}),
        ("euclidean_no_opt", {}),
        ("cosine", {}),
        ("manhattan", {}),
        ("manhattan_no_opt", {}),
        ("norm_p", {"p": 2}),
        ("norm_p", {"p": 4.0}),
        ("norm_p", {"p": 3}),
        ("norm_p", {"p": 1.5}),
        ("norm_p", {"p": -1}),
        ("norm_p", {"p": 0}),
        ("norm_p_no_opt", {"p": 2.5}),
    ],
)
def test_distance_registry_matches_jax(name, kwargs):
    rng = np.random.RandomState(len(name))
    x = (rng.rand(40, 6) + 0.1).astype(np.float32)
    w = (rng.rand(30, 6) + 0.1).astype(np.float32)
    x[3] = 0.0  # a zero row (cosine's nan_to_num)
    ref_fn = jdist.DistanceFunction(name, kwargs)
    fn = tdist.DistanceFunction(name, kwargs)
    assert fn.can_cache == ref_fn.can_cache
    w_sq = (w.astype(np.float64) ** 2).sum(1, keepdims=True).astype(np.float32)
    for wsq in (None, w_sq):
        got = fn.flat(torch.from_numpy(x), torch.from_numpy(w),
                      None if wsq is None else torch.from_numpy(wsq))
        want = ref_fn.flat(jnp.asarray(x), jnp.asarray(w),
                           None if wsq is None else jnp.asarray(wsq))
        assert got.shape == (40, 30) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the (X, Y, D) form flattens the codebook
    np.testing.assert_array_equal(
        fn(torch.from_numpy(x), torch.from_numpy(w.reshape(5, 6, 6))).numpy(),
        fn.flat(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
    )


def test_distance_registry_names_and_errors():
    assert tdist.DISTANCE_NAMES == jdist.DISTANCE_NAMES
    with pytest.raises(ValueError, match="not supported"):
        tdist.DistanceFunction("chebyshev")
    x = torch.rand(3, 2)
    for p in (3, -2, 0):
        with pytest.raises(ValueError, match="even"):
            tdist.norm_p_power_distance_even(x, x, p)
    got = tdist.euclidean_distance(x, x)
    assert torch.all(got.diagonal() < 1e-3) and torch.all(got >= 0)


@pytest.mark.parametrize(
    "name,kwargs,kind",
    [
        ("euclidean", {}, "euclidean"),
        ("cosine", {}, "cosine"),
        ("manhattan", {}, "manhattan"),
        ("norm_p", {}, "norm_p_even"),
        ("norm_p", {"p": 6.0}, "norm_p_even"),
        ("norm_p", {"p": 1}, "norm_p_odd"),
        ("norm_p", {"p": 3.0}, "norm_p_odd"),
        ("norm_p", {"p": 0.5}, "norm_p_frac"),
        ("norm_p", {"p": 0}, None),
        ("norm_p", {"p": -2}, None),
        ("norm_p", {"p": -1.5}, None),
        ("euclidean_no_opt", {}, None),
        ("manhattan_no_opt", {}, None),
        ("norm_p_no_opt", {"p": 3}, None),
    ],
)
def test_kernel_gate_routes_like_the_jax_gate(name, kwargs, kind, monkeypatch):
    """The port's gate against the JAX gate with the TPU backend stood in,
    and None without kernels. The port's gate takes no width: at D = 4096
    the JAX gate falls back to XLA (Mosaic bounds) where the port keeps
    its kernel."""
    dist = tdist.DistanceFunction(name, kwargs)
    assert tcore._kernel_bmu_kind(dist) == kind
    assert tcore._kernel_bmu_kind(dist, use_kernels=False) is None
    monkeypatch.setattr(jcore.jax, "default_backend", lambda: "tpu")
    assert jcore._pallas_bmu_kind(jdist.DistanceFunction(name, kwargs), 16) == kind
    # no Mosaic width bound here: a D the JAX gate sends to XLA stays a
    # kernel route in the port
    if kind is not None:
        assert jcore._pallas_bmu_kind(jdist.DistanceFunction(name, kwargs), 4096) is None


def _models(dist, kwargs, mode, **kw):
    """Port, JAX and golden models with identical initial weights."""
    args = dict(sigma=2.5, random_seed=9, activation_distance=dist,
                activation_distance_kwargs=kwargs, **kw)
    ours = XPySom(8, 7, 10, device="cpu", bmu_precision=mode, **args)
    ref = JaxSom(8, 7, 10, bmu_precision=mode, **args)
    gold = GoldenSom(8, 7, 10, sigma=2.5, random_seed=9, distance=dist, distance_kwargs=kwargs)
    np.testing.assert_array_equal(ours.get_weights(), ref.get_weights())
    np.testing.assert_array_equal(ours.get_weights(), gold.weights)
    return ours, ref, gold


@pytest.mark.parametrize("dist,kwargs,mode", CONFIGS, ids=_IDS)
def test_whole_path_matches_jax_and_golden(dist, kwargs, mode):
    """train → winner → QE → TE under each activation and mode, with the
    tolerances of tests/test_training_parity.py: BMU agreement > 0.995 at
    the identical initial weights, QE within 2e-3 relative after 6
    epochs."""
    rng = np.random.RandomState(6)
    data = (rng.rand(1200, 10) + 0.1).astype(np.float32)
    ours, ref, gold = _models(dist, kwargs, mode)
    bmu = ours.predict(data)
    assert np.mean(bmu == gold.bmu(data)) > 0.995
    assert np.mean(bmu == ref.predict(data)) > 0.995
    assert ours.winner(data[:3]) == [(int(b) // 7, int(b) % 7) for b in bmu[:3]]

    for som in (ours, ref, gold):
        som.train(data, 6)
    qe, qe_ref, qe_gold = (s.quantization_error(data) for s in (ours, ref, gold))
    assert abs(qe - qe_gold) / qe_gold < 2e-3, (qe, qe_gold)
    assert abs(qe - qe_ref) / qe_ref < 2e-3, (qe, qe_ref)
    te, te_ref = ours.topographic_error(data), ref.topographic_error(data)
    assert 0.0 <= te <= 1.0 and abs(te - te_ref) <= 0.02, (te, te_ref)


@pytest.mark.parametrize("dist,kwargs,mode", CONFIGS, ids=_IDS)
def test_plain_and_kernel_routes_agree_for_each_activation(dist, kwargs, mode):
    """use_kernels=False runs each route's plain versions; on the CPU the
    wrappers run the same plain versions, so the two trainings agree bit
    for bit."""
    data = np.random.RandomState(1).rand(200, 10).astype(np.float32)
    a = _models(dist, kwargs, mode)[0].train(data, 3)
    b = XPySom(8, 7, 10, device="cpu", sigma=2.5, random_seed=9, activation_distance=dist,
               activation_distance_kwargs=kwargs, bmu_precision=mode,
               use_kernels=False).train(data, 3)
    np.testing.assert_array_equal(a.get_weights(), b.get_weights())


# -- the three repaired faults -------------------------------------------------


def test_probe_spec_resolves_norm_p_to_highest():
    assert XPySom(4, 4, 3, device="cpu", activation_distance="norm_p")._bmu_precision == "highest"
    assert XPySom(4, 4, 3, device="cpu")._bmu_precision == "packed"
    explicit = XPySom(4, 4, 3, device="cpu", activation_distance="norm_p", bmu_precision="packed")
    assert explicit._bmu_precision == "packed"
    assert "bmu_precision='highest'" in repr(XPySom(4, 4, 3, device="cpu",
                                                    activation_distance="norm_p"))
    with pytest.raises(ValueError, match="margin"):
        XPySom(4, 4, 3, device="cpu", activation_distance="norm_p", bmu_precision="margin")
    with pytest.raises(ValueError, match="margin"):
        JaxSom(4, 4, 3, activation_distance="norm_p", bmu_precision="margin")
    # margin is served for the other activations
    assert XPySom(4, 4, 3, device="cpu", bmu_precision="margin")._bmu_precision == "margin"


def test_qe_searches_under_the_specs_mode(monkeypatch):
    """QE's euclidean search runs in the spec's mode (K4 under 'highest',
    as the JAX QE runs K4 there) and matches the JAX QE; winners search by
    the activation, not by euclidean distance."""
    rng = np.random.RandomState(2)
    data = (rng.rand(500, 5) * 3 + 2).astype(np.float32)
    calls = []
    real = kb.bmu_highest
    monkeypatch.setattr(kb, "bmu_highest", lambda *a: calls.append(1) or real(*a))
    for mode in ("highest", "packed"):
        ours = XPySom(6, 5, 5, device="cpu", random_seed=3, bmu_precision=mode)
        ref = JaxSom(6, 5, 5, random_seed=3, bmu_precision=mode)
        ours.train(data, 4)
        ref.train(data, 4)
        calls.clear()
        qe = ours.quantization_error(data)
        assert bool(calls) == (mode == "highest")
        np.testing.assert_allclose(qe, ref.quantization_error(data), rtol=1e-5)
    som = XPySom(6, 5, 5, device="cpu", random_seed=3, activation_distance="manhattan")
    gold = GoldenSom(6, 5, 5, random_seed=3, distance="manhattan")
    np.testing.assert_array_equal(som.predict(data), gold.bmu(data))


@pytest.mark.parametrize(
    "kwargs,fused",
    [
        ({}, True),
        ({"activation_distance": "manhattan"}, True),
        ({"activation_distance": "norm_p", "activation_distance_kwargs": {"p": 1.5}}, True),
        ({"activation_distance": "manhattan_no_opt"}, False),
        ({"activation_distance": "norm_p", "activation_distance_kwargs": {"p": -1}}, False),
        ({"use_kernels": False}, False),
    ],
)
def test_default_chunk_follows_the_gate(kwargs, fused):
    """On the card the kernels' chunk (16384) is the default only where a
    kernel serves the search; a plain distance matrix keeps the budget
    (chunk · XY floats). ``_matrix_chunk`` budgets the matrix paths."""
    som = XPySom(128, 128, 8, device="cuda", **kwargs)  # builds no tensor
    budget = default_n_parallel(128 * 128, "cuda")
    assert som._n_parallel == (16384 if fused else budget)
    assert som._matrix_chunk == budget
    explicit = XPySom(128, 128, 8, device="cuda", n_parallel=4096, **kwargs)
    assert explicit._n_parallel == explicit._matrix_chunk == 4096
    cpu = XPySom(128, 128, 8, device="cpu", **kwargs)
    assert cpu._n_parallel == cpu._matrix_chunk == default_n_parallel(128 * 128, "cpu")


def test_matrix_route_serves_no_opt_and_nonpositive_p():
    """The routes without a kernel run the plain distance matrix and agree
    with the golden model's BMUs."""
    rng = np.random.RandomState(7)
    data = (rng.rand(300, 4) + 0.2).astype(np.float32)
    for dist, kwargs in (("manhattan_no_opt", {}), ("norm_p", {"p": -1}),
                         ("euclidean_no_opt", {}), ("norm_p_no_opt", {"p": 3})):
        som = XPySom(5, 4, 4, device="cpu", random_seed=2, activation_distance=dist,
                     activation_distance_kwargs=kwargs)
        gold = GoldenSom(5, 4, 4, random_seed=2, distance=dist, distance_kwargs=kwargs)
        assert np.mean(som.predict(data) == gold.bmu(data)) > 0.995
        search = tcore._searcher(som._spec, som._spec.distance_fn(),
                                 torch.from_numpy(som.get_weights().reshape(20, 4)).float())
        assert isinstance(search, tcore._MatrixSearch)
        som.train(data, 2)
        assert np.isfinite(som.quantization_error(data))


def test_searchers_follow_the_routes():
    w = torch.rand(12, 3)
    spec = XPySom(4, 3, 3, device="cpu")._spec
    for dist, kwargs, cls in (
        ("euclidean", {}, kb.PackedCodebook),
        ("cosine", {}, kb.PackedCodebook),
        ("norm_p", {"p": 4}, kb.NormPEvenCodebook),
        ("manhattan", {}, ke.ElementwiseCodebook),
        ("norm_p", {"p": 3}, ke.ElementwiseCodebook),
        ("norm_p", {"p": 2.5}, ke.ElementwiseCodebook),
    ):
        search = tcore._searcher(spec, tdist.DistanceFunction(dist, kwargs), w)
        assert isinstance(search, cls), dist
