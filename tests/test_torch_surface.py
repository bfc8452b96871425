"""The PyTorch port's analysis surface against the JAX package, on the CPU
at small sizes: the plain K8 against the Pallas L1-matrix kernel in
interpret mode, ``activate`` under every activation,
``distance_from_weights``, ``quantization``, ``activation_response``,
``win_map``, ``labels_map``, ``distance_map`` and the coordinate helpers
on both topologies, and the default-device rule. Inputs are made with
numpy from fixed seeds and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu.ops.pallas import manhattan as pl_manhattan
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.ops import distances as tdist
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.kernels import manhattan as km


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("n,xy,d", [(37, 91, 5), (300, 1100, 24), (8, 3, 1)])
def test_plain_k8_bitwise_equals_pallas_interpret(n, xy, d):
    rng = np.random.RandomState(n + xy)
    x = (rng.randn(n, d) * 3).astype(np.float32)
    w = (rng.randn(xy, d) * 3).astype(np.float32)
    got = km.manhattan_distance(torch.from_numpy(x), torch.from_numpy(w))
    ref = pl_manhattan.manhattan_distance(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert got.shape == (n, xy) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    # the distances module's 'manhattan' is K8 (its plain version here)
    np.testing.assert_array_equal(
        _bits(tdist.manhattan_distance(torch.from_numpy(x), torch.from_numpy(w)).numpy()),
        _bits(ref))


def test_k8_wrapper_validates_inputs():
    x = torch.rand(4, 3)
    with pytest.raises(TypeError, match="float32"):
        km.manhattan_distance(x.double(), x)
    with pytest.raises(ValueError, match=r"\(XY, D\)"):
        km.manhattan_distance(x, x[:, :2])


def _pair(x, y, d, **kw):
    ours = XPySom(x, y, d, random_seed=4, device="cpu", **kw)
    ref = JaxSom(x, y, d, random_seed=4, **kw)
    np.testing.assert_array_equal(ours.get_weights(), ref.get_weights())
    return ours, ref


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("euclidean", {}),
        ("cosine", {}),
        ("manhattan", {}),
        ("norm_p", {"p": 3}),
        ("norm_p", {"p": 4}),
        ("norm_p", {"p": 1.5}),
        ("euclidean_no_opt", {}),
        ("manhattan_no_opt", {}),
        ("norm_p_no_opt", {"p": 2.5}),
    ],
)
def test_activate_matches_jax(name, kwargs):
    rng = np.random.RandomState(len(name))
    data = (rng.rand(70, 6) + 0.1).astype(np.float32)
    ours, ref = _pair(5, 4, 6, activation_distance=name, activation_distance_kwargs=kwargs,
                      n_parallel=32)  # several chunks
    got, want = ours.activate(data), ref.activate(data)
    assert isinstance(got, np.ndarray) and got.shape == (70, 20) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # one sample gives a (1, XY) map (a one-row GEMM may round apart)
    np.testing.assert_allclose(ours.activate(data[0]), got[:1], rtol=1e-6, atol=1e-6)


def test_activate_manhattan_plain_and_kernel_routes_agree():
    """``use_kernels=False`` runs K8's plain version; on the CPU the K8
    wrapper runs the same plain version: equal bits, no launch counted."""
    rng = np.random.RandomState(3)
    data = rng.rand(90, 5).astype(np.float32)
    kernels.reset_launch_counts()
    a = XPySom(6, 5, 5, random_seed=1, device="cpu", activation_distance="manhattan")
    b = XPySom(6, 5, 5, random_seed=1, device="cpu", activation_distance="manhattan",
               use_kernels=False)
    np.testing.assert_array_equal(_bits(a.activate(data)), _bits(b.activate(data)))
    assert kernels.launch_counts()["manhattan_distance"] == 0


@pytest.mark.parametrize("explicit", [False, True])
def test_distance_from_weights_matches_jax(explicit):
    rng = np.random.RandomState(6)
    data = rng.rand(80, 4).astype(np.float32)
    ours, ref = _pair(4, 6, 4, n_parallel=16)
    weights = rng.rand(3, 5, 4) if explicit else None
    got = ours.distance_from_weights(data, weights=weights)
    want = np.asarray(ref.distance_from_weights(data, weights=weights))
    assert got.shape == (80, 15 if explicit else 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    w = (weights if explicit else ours.get_weights()).reshape(-1, 4)
    d64 = np.sqrt(((data[:, None].astype(np.float64) - w[None]) ** 2).sum(-1))
    np.testing.assert_allclose(got, d64, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("topology", ["rectangular", "hexagonal"])
def test_scoring_surface_matches_jax(topology):
    """quantization (euclidean BMUs under a manhattan activation),
    activation_response, win_map and labels_map on a trained map."""
    rng = np.random.RandomState(2)
    data = rng.rand(200, 5).astype(np.float32)
    labels = rng.randint(0, 3, 200)
    ours, ref = _pair(6, 6, 5, topology=topology, activation_distance="manhattan")
    ref.train(data, 3)
    ours._weights = np.asarray(ref._weights).copy()
    np.testing.assert_array_equal(ours.quantization(data), np.asarray(ref.quantization(data)))
    np.testing.assert_array_equal(ours.activation_response(data), ref.activation_response(data))
    wm, wm_ref = ours.win_map(data), ref.win_map(data)
    assert wm.keys() == wm_ref.keys()
    for k in wm:
        np.testing.assert_array_equal(np.array(wm[k]), np.array(wm_ref[k]))
    assert ours.labels_map(data, labels) == ref.labels_map(data, labels)
    with pytest.raises(ValueError, match="same length"):
        ours.labels_map(data, labels[:5])
    # a streamed source (ROADMAP Queue 1 item 9, ported): the same counts
    from xpysom_dask_tpu_torch.parallel.pipeline import ArraySource

    np.testing.assert_array_equal(ours.activation_response(ArraySource(data)),
                                  ref.activation_response(data))


@pytest.mark.parametrize("topology,x,y", [("rectangular", 6, 4), ("hexagonal", 6, 6),
                                          ("hexagonal", 5, 7)])
def test_distance_map_and_coordinates_match_jax(topology, x, y):
    ours, ref = _pair(x, y, 3, topology=topology)
    np.testing.assert_array_equal(ours.distance_map(), ref.distance_map())
    for mine, want in zip(ours.get_euclidean_coordinates(), ref.get_euclidean_coordinates()):
        np.testing.assert_array_equal(mine, want)
    for cell in ((0, 0), (1, 2), (x - 1, y - 1)):
        assert ours.convert_map_to_euclidean(cell) == ref.convert_map_to_euclidean(cell)


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    """Without a card, a model with no ``device=`` raises and says to pass
    device='cpu'; with ``device='cpu'`` it constructs. Neither builds a
    tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_tensors(*a, **k):
        raise AssertionError("a tensor was built")

    for name in ("tensor", "from_numpy", "zeros", "empty", "as_tensor"):
        monkeypatch.setattr(torch, name, no_tensors)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        XPySom(4, 4, 3)
    som = XPySom(4, 4, 3, device="cpu")
    assert som._device == torch.device("cpu")
