"""The PyTorch port's hexagonal topology against the JAX package and the
float64 golden model, on the CPU at small sizes: the per-parity-class
neighborhood operator, training under the configurations of
tests/test_training_parity.py, and hexagonal TE. Inputs are made with
numpy from fixed seeds and handed to every package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu.models.golden import GoldenSom
from xpysom_dask_tpu.ops import neighborhoods as jnb
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch import core as tcore
from xpysom_dask_tpu_torch.ops import neighborhoods as tnb

# the hexagonal configurations of tests/test_training_parity.py:42-52
HEX_CONFIGS = [
    {},
    {"neighborhood_function": "mexican_hat"},
    {"neighborhood_function": "bubble", "sigma": 2.0},
    {"neighborhood_function": "mexican_hat", "compact_support": True, "sigma": 2.0},
]
_IDS = ["gaussian", "mexican_hat", "bubble", "mexican_hat_compact"]


@pytest.mark.parametrize("x,y", [(7, 6), (6, 5)])
@pytest.mark.parametrize("name", ["gaussian", "mexican_hat", "bubble"])
@pytest.mark.parametrize("compact", [False, True])
def test_hex_operator_and_apply_match_jax(x, y, name, compact):
    sigma = 2.3
    rng = np.random.RandomState(3)
    s = rng.rand(x * y, 6).astype(np.float32)
    cnt = rng.randint(0, 9, x * y).astype(np.float32)
    xx, yy = tcore.grid_coordinates(x, y, "hexagonal")
    jop = jnb.neighborhood_operator(
        name, "hexagonal", jnp.arange(x, dtype=jnp.float32), jnp.arange(y, dtype=jnp.float32),
        jnp.asarray(xx, jnp.float32), jnp.asarray(yy, jnp.float32), 0.7, compact,
        jnp.float32(sigma),
    )
    top = tnb.neighborhood_operator(
        name, "hexagonal", torch.arange(x, dtype=torch.float32),
        torch.arange(y, dtype=torch.float32), 0.7, compact, torch.tensor(sigma),
    )
    assert len(top[1]) == len(jop[1]) == {"gaussian": 3, "mexican_hat": 9, "bubble": 1}[name]
    for (tax, tay), (jax_, jay) in zip(top[1], jop[1]):
        np.testing.assert_allclose(tax.numpy(), np.asarray(jax_), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tay.numpy(), np.asarray(jay), rtol=1e-6, atol=1e-6)
    num, den = tnb.apply_operator(top, torch.from_numpy(s), torch.from_numpy(cnt))
    jnum, jden = jnb.apply_operator(jop, jnp.asarray(s), jnp.asarray(cnt))
    for mine, ref in ((num, jnum), (den, jden)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_hex_operator_rejects_other_kernels_with_the_jax_message():
    args = (torch.arange(4.0), torch.arange(4.0), 0.5, False, torch.tensor(1.0))
    with pytest.raises(ValueError, match="'triangle' neighborhood not available for hexagonal"):
        tnb.neighborhood_operator("triangle", "hexagonal", *args)
    with pytest.raises(ValueError, match="unknown topology"):
        tnb.neighborhood_operator("gaussian", "triangular", *args)


@pytest.mark.parametrize("kw", HEX_CONFIGS, ids=_IDS)
def test_hex_training_matches_golden_and_jax(kw):
    """Each epoch from the golden model's codebook: the port's epoch and
    the JAX package's land within the golden tolerance (rtol 1e-3, atol
    1e-4) of the golden epoch. Epoch by epoch, because the mexican-hat
    operator's den nearly cancels at some nodes, so a whole run amplifies
    f32 rounding chaotically. The tie-prone configurations (bubble,
    compact support: codebook rows become exactly equal) follow
    tests/test_training_parity.py: one tight epoch, then QE within 5e-2
    over the whole run."""
    rng = np.random.RandomState(11)
    data = rng.rand(200, 4).astype(np.float32)
    ours = XPySom(6, 5, 4, random_seed=42, device="cpu", topology="hexagonal", **kw)
    ref = JaxSom(6, 5, 4, random_seed=42, topology="hexagonal", **kw)
    gold = GoldenSom(
        6, 5, 4, sigma=kw.get("sigma", 0), neighborhood=kw.get("neighborhood_function", "gaussian"),
        topology="hexagonal", compact_support=kw.get("compact_support", False), random_seed=42,
    )
    np.testing.assert_array_equal(ours.get_weights(), gold.weights)
    tie_prone = kw.get("neighborhood_function") == "bubble" or kw.get("compact_support", False)
    tight = 1 if tie_prone else 5
    for t in range(tight):
        w_in = np.array(gold.weights, dtype=np.float32)
        ours._weights = w_in.copy()
        ref._weights = w_in.copy()
        gold.train(data, 5, iter_beg=t, iter_end=t + 1)
        ours.train(data, 5, iter_beg=t, iter_end=t + 1)
        ref.train(data, 5, iter_beg=t, iter_end=t + 1)
        np.testing.assert_allclose(ours.get_weights(), gold.weights, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(ours.get_weights(), ref.get_weights(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        ours.quantization_error(data), gold.quantization_error(data), rtol=1e-5, atol=1e-6
    )
    if tie_prone:
        ours.train(data, 5, iter_beg=tight, iter_end=5)
        gold.train(data, 5, iter_beg=tight, iter_end=5)
        np.testing.assert_allclose(
            ours.quantization_error(data), gold.quantization_error(data), rtol=5e-2
        )


def test_hex_gaussian_whole_run_matches_golden():
    rng = np.random.RandomState(11)
    data = rng.rand(200, 4).astype(np.float32)
    ours = XPySom(6, 5, 4, random_seed=42, device="cpu", topology="hexagonal")
    gold = GoldenSom(6, 5, 4, topology="hexagonal", random_seed=42)
    ours.train(data, 5)
    gold.train(data, 5)
    np.testing.assert_allclose(ours.get_weights(), gold.weights, rtol=1e-3, atol=1e-4)


def _clean_rows(data, w):
    """Rows whose float64 top-3 distances are apart: no near-tie decides
    the top-2 pair."""
    d = ((data[:, None].astype(np.float64) - w[None]) ** 2).sum(-1)
    s = np.sort(d, axis=1)
    return data[(s[:, 1] - s[:, 0] > 1e-4) & (s[:, 2] - s[:, 1] > 1e-4)]


@pytest.mark.parametrize("mode", ["packed", "margin"])
def test_hex_topographic_error_matches_jax(mode):
    rng = np.random.RandomState(5)
    data = rng.rand(600, 5).astype(np.float32)
    ref = JaxSom(7, 7, 5, random_seed=3, topology="hexagonal", bmu_precision=mode)
    ref.train(data, 4)
    w = np.asarray(ref._weights, dtype=np.float32)
    probe = _clean_rows(data, w.reshape(-1, 5))
    assert len(probe) > 400
    ours = XPySom.from_numpy(w, random_seed=3, device="cpu", topology="hexagonal",
                             bmu_precision=mode)
    te, te_ref = ours.topographic_error(probe), ref.topographic_error(probe)
    assert 0.0 < te < 1.0
    assert te == te_ref
    # the rectangular rule on the same codebook counts differently
    rect = XPySom.from_numpy(w, random_seed=3, device="cpu")
    assert rect.topographic_error(probe) != te


def test_hex_topographic_error_refuses_non_square_maps():
    som = XPySom(5, 4, 3, device="cpu", topology="hexagonal")
    with pytest.raises(ValueError, match="square map"):
        som.topographic_error(np.zeros((3, 3), np.float32))


def test_hex_constructor_rules_match_jax():
    for cls, kw in ((XPySom, {"device": "cpu"}), (JaxSom, {})):
        with pytest.warns(UserWarning, match="triangle"):
            with pytest.raises(ValueError, match="not supported"):
                cls(4, 4, 3, topology="hexagonal", neighborhood_function="triangle", **kw)
    ours = XPySom(5, 4, 3, device="cpu", topology="hexagonal")
    ref = JaxSom(5, 4, 3, topology="hexagonal")
    np.testing.assert_array_equal(ours._xx, ref._xx)
    np.testing.assert_array_equal(ours._yy, ref._yy)
