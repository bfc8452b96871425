"""The plain reference against a float64 NumPy batch SOM written the
naive way (every sample's neighbourhood materialized), at a tiny size."""

import math

import numpy as np
import pytest
import torch

from reference import som as ref

KW = dict(x=5, y=4, input_len=3, sigma=2.5, sigmaN=1.0, learning_rate=0.5, learning_rateN=0.01)


def _numpy_som(X, w0, epochs, activation):
    x, y = KW["x"], KW["y"]
    gx, gy = np.meshgrid(np.arange(x), np.arange(y), indexing="ij")
    w = w0.reshape(x * y, -1).astype(np.float64)
    X = X.astype(np.float64)
    for t in range(epochs):
        eta = 0.5 * math.exp(-t * math.log(0.5 / 0.01) / epochs)
        sig = 2.5 * math.exp(-t * math.log(2.5 / 1.0) / epochs)
        d = 2 * 0.25 * sig ** 2
        if activation == "euclidean":
            dist = ((X[:, None, :] - w[None]) ** 2).sum(-1)
        else:
            dist = np.abs(X[:, None, :] - w[None]).sum(-1)
        b = dist.argmin(1)
        bx, by = b // y, b % y
        h = np.exp(-((gx.reshape(1, -1) - bx[:, None]) ** 2) / d) * np.exp(
            -((gy.reshape(1, -1) - by[:, None]) ** 2) / d)  # (N, XY)
        num, den = eta * h.T @ X, eta * h.sum(0)
        w = np.where(den[:, None] != 0, num / den[:, None], w)
    return w.reshape(x, y, -1)


@pytest.mark.parametrize("activation", ["euclidean", "manhattan"])
def test_training_matches_a_naive_float64_som(activation):
    rng = np.random.default_rng(7)
    X = rng.random((200, 3)).astype(np.float32)
    w0 = X[rng.integers(0, 200, 20)].reshape(5, 4, 3)
    cfg = ref.SomConfig(**KW, activation=activation)
    got = ref.train(cfg, torch.from_numpy(X), torch.from_numpy(w0), 6, torch.float64).numpy()
    np.testing.assert_allclose(got, _numpy_som(X, w0, 6, activation), rtol=1e-12, atol=1e-12)


def test_scores_match_numpy():
    rng = np.random.default_rng(8)
    X = rng.random((300, 3)).astype(np.float32)
    w = rng.random((5, 4, 3))
    d = ((X[:, None, :].astype(np.float64) - w.reshape(20, 3)[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1)
    qe = np.sqrt(d[np.arange(300), order[:, 0]]).mean()
    a, b = order[:, 0], order[:, 1]
    te = np.mean((np.abs(a // 4 - b // 4) > 1) | (np.abs(a % 4 - b % 4) > 1))
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    assert ref.quantization_error(Xt, wt) == pytest.approx(qe, rel=1e-12)
    assert ref.topographic_error(Xt, wt, 4) == te
    gaps = ref.winner_gaps(Xt, wt, torch.from_numpy(b))
    np.testing.assert_allclose(gaps.numpy(), d[np.arange(300), b] - d[np.arange(300), a], atol=1e-12)
    assert float(ref.winner_gaps(Xt, wt, torch.from_numpy(a)).abs().max()) < 1e-12


def test_the_reference_imports_nothing_of_the_program():
    with open(ref.__file__) as f:
        text = f.read()
    assert "xpysom" not in text.replace("upstream xpysom", "")
