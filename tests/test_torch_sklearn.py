"""The port's sklearn adapter (``xpysom_dask_tpu_torch/sklearn.py``) on the
CPU: twins of ``tests/test_sklearn.py`` with ``device='cpu'``, the
device rule, and parity with the JAX package's ``SomClusterer`` on the
same blobs and seed."""

import numpy as np
import pytest
import torch

sklearn = pytest.importorskip("sklearn")

from sklearn.base import clone
from sklearn.exceptions import NotFittedError
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler

from xpysom_dask_tpu.sklearn import SomClusterer as JaxClusterer
from xpysom_dask_tpu_torch.sklearn import SomClusterer

# the JAX golden-parity tolerance (tests/test_training_parity.py)
RTOL, ATOL = 1e-3, 1e-4
# the packed search's stated error floor: a winner may differ from the
# exact one only where the two float64 distances are within 2^-17 *
# sum_d |x_d||2 w_d| (centred by the codebook's mean)
NEAR_TIE = 2.0**-17


def _blobs(n=300, d=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(3, d) * 6
    return np.concatenate(
        [c + 0.2 * rng.randn(n // 3, d) for c in centers]
    ).astype(np.float32)


def _est(*args, **kw):
    return SomClusterer(*args, device="cpu", **kw)


def test_fit_predict_transform_shapes():
    X = _blobs()
    est = _est(5, 4, num_epochs=8, sigma=2.0, random_seed=3)
    labels = est.fit_predict(X)
    assert labels.shape == (300,)
    assert labels.min() >= 0 and labels.max() < 20
    assert est.cluster_centers_.shape == (20, 4)
    d = est.transform(X[:7])
    assert d.shape == (7, 20)
    # predict == argmin of transform (euclidean contract)
    np.testing.assert_array_equal(est.predict(X[:7]), d.argmin(1))
    # inverse_transform returns codebook rows
    np.testing.assert_allclose(
        est.inverse_transform(labels[:5]), est.cluster_centers_[labels[:5]]
    )
    with pytest.raises(ValueError, match=r"flat grid indices in \[0, 20\)"):
        est.inverse_transform([-1])


def test_separates_blobs():
    X = _blobs()
    est = _est(6, 6, num_epochs=15, sigma=2.5, random_seed=1).fit(X)
    labels = est.predict(X)
    # samples of the same blob should concentrate on few nodes, and the
    # three blobs must not collapse onto one node
    assert len(set(labels.tolist())) >= 3
    assert est.quantization_error_ < 0.5
    assert -est.score(X) == pytest.approx(est.som_.quantization_error(X))


@pytest.mark.parametrize("mesh", [None, "auto"])
def test_pipeline_and_clone(mesh):
    X = _blobs(seed=5)
    pipe = make_pipeline(StandardScaler(), _est(4, 4, num_epochs=5, random_seed=2, mesh=mesh))
    labels = pipe.fit_predict(X)
    assert labels.shape == (300,)
    est = _est(4, 3, num_epochs=2, sigma=1.5, random_seed=7, mesh=mesh)
    est2 = clone(est)
    assert est2.get_params() == est.get_params()
    est2.set_params(num_epochs=3)
    assert est2.num_epochs == 3 and est.num_epochs == 2


def test_validation_errors():
    X = _blobs()
    est = _est(4, 4, num_epochs=2, random_seed=1).fit(X)
    with pytest.raises(ValueError):
        est.predict(X[:, :2])  # wrong feature count
    with pytest.raises(ValueError, match="init='bogus' not supported"):
        _est(4, 4, init="bogus").fit(X)
    with pytest.raises(NotFittedError):
        _est(4, 4).predict(X)


def test_init_modes():
    X = _blobs(seed=9)
    for init in ("random", "pca", "samples"):
        est = _est(4, 4, num_epochs=3, random_seed=4, init=init).fit(X)
        assert est.quantization_error_ < 2.0


def test_params_are_jax_params_plus_device():
    ours = set(SomClusterer().get_params())
    assert ours == set(JaxClusterer().get_params()) | {"device"}
    assert SomClusterer().get_params()["device"] is None


def test_activation_distance_kwargs_are_forwarded():
    """None (the default) reaches XPySom as {}, a dict as given."""
    X = _blobs()
    est = _est(3, 3, num_epochs=1, random_seed=0).fit(X)
    assert est.som_._activation_distance_kwargs == {}
    est = _est(3, 3, num_epochs=1, random_seed=0, activation_distance="norm_p",
               activation_distance_kwargs={"p": 3}).fit(X)
    assert est.som_._activation_distance_kwargs == {"p": 3}


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    """Without a card, an adapter with no ``device`` raises the port's
    RuntimeError at fit and never trains on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est = SomClusterer(3, 3, num_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.fit(_blobs())
    assert not hasattr(est, "som_")


def test_fit_does_not_copy_float32_input(monkeypatch):
    """A C-contiguous float32 array reaches ``XPySom.train`` as itself:
    validation makes no copy."""
    X = _blobs()
    seen = []
    from xpysom_dask_tpu_torch import XPySom

    train = XPySom.train

    def spy(self, data, *args, **kw):
        seen.append(data)
        return train(self, data, *args, **kw)

    monkeypatch.setattr(XPySom, "train", spy)
    _est(3, 3, num_epochs=1, random_seed=0).fit(X)
    assert seen and seen[0] is X


def _check_flips(X, w_flat, got, want):
    """Every label that differs is a float64 near-tie of the packed
    search: the two nodes' distances within its floor."""
    rows = np.nonzero(got != want)[0]
    if not len(rows):
        return
    w = w_flat.astype(np.float64)
    c = w.mean(0)
    x = X[rows].astype(np.float64)
    d_got = ((x - w[got[rows]]) ** 2).sum(1)
    d_want = ((x - w[want[rows]]) ** 2).sum(1)
    scale = (np.abs(x - c)[:, None, :] * np.abs(2 * (w - c))[None]).sum(-1).max(1)
    assert np.all(np.abs(d_got - d_want) <= NEAR_TIE * scale), rows


@pytest.mark.parametrize("init", ["random", "pca", "samples"])
def test_matches_jax(init):
    """Both packages' adapters fit the same standardized blobs (the
    adapter's pipeline use) from the same seed: the same codebook,
    distances and score within the golden-parity tolerance, the same
    labels but for float64 near-ties.

    A map whose early neighbourhood spans the whole grid draws its nodes
    together, every sample is then a float64 near-tie of the packed search
    (gaps ~1e-7 relative, far inside its 2^-17 floor), and the two
    packages' correct searches send some of them to different nodes; the
    maps then part for good. On the raw blobs that happens within one
    epoch, so parity is held where it is defined: standardized data and a
    4 x 4 map."""
    X = StandardScaler().fit_transform(_blobs(seed=9)).astype(np.float32)
    kw = dict(x=4, y=4, num_epochs=5, random_seed=4, init=init)
    ours = _est(**kw).fit(X)
    ref = JaxClusterer(**kw).fit(X)
    np.testing.assert_allclose(ours.cluster_centers_, ref.cluster_centers_, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.transform(X), ref.transform(X), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.score(X), ref.score(X), rtol=RTOL, atol=ATOL)
    _check_flips(X, ours.cluster_centers_, ours.labels_, np.asarray(ref.labels_))
