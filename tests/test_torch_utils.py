"""The port's host helpers (``utils.hw``) and ``utils.profiling.epoch_anatomy``
on the CPU: twins of ``tests/test_hw.py::test_find_cpu_cores_positive`` and
``tests/test_review_fixes.py::test_epoch_anatomy_public_api``, and what the
anatomy must leave alone."""

import numpy as np
import pytest
import torch

from xpysom_dask_tpu import utils as jutils
from xpysom_dask_tpu.utils import hw as jhw
from xpysom_dask_tpu_torch import XPySom, utils
from xpysom_dask_tpu_torch.utils import hw
from xpysom_dask_tpu_torch.utils.profiling import epoch_anatomy


def test_find_cpu_cores_positive():
    assert hw.find_cpu_cores() >= 1
    assert hw.find_cpu_cores() == jhw.find_cpu_cores()


def test_backend_kind_names_the_card_in_jax_words(monkeypatch):
    assert hw.backend_kind() == jhw.backend_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert hw.backend_kind() == "gpu"


def test_utils_export_the_jax_helpers():
    for name in ("find_cpu_cores", "backend_kind", "round_up", "default_n_parallel"):
        assert name in utils.__all__ and name in jutils.__all__
        assert getattr(utils, name) is getattr(hw, name)
    assert utils.round_up(257, 256) == jutils.round_up(257, 256) == 512


@pytest.mark.parametrize("activation", ["euclidean", "manhattan"])
def test_epoch_anatomy_public_api(activation):
    """Keys, finite values, a positive epoch cost and the sum identity, as
    the JAX test holds them (mechanics only on the CPU: the numbers that
    matter are measured on the card); and the model is left as it was."""
    som = XPySom(6, 6, 8, random_seed=0, n_parallel=256, device="cpu",
                 activation_distance=activation)
    som._checkpoint_epoch = 5
    data = np.random.RandomState(0).rand(512, 8).astype(np.float32)
    w0 = som.get_weights().copy()
    rng0 = som._random_generator.get_state()
    out = epoch_anatomy(som, data, lo=1, hi=3, reps=2)
    for k in ("bmu_ms", "stats_ms", "epoch_ms", "scatter_ms", "update_ms"):
        assert k in out and np.isfinite(out[k]), (k, out)
    assert out["epoch_ms"] > 0
    assert abs(out["bmu_ms"] + out["scatter_ms"] + out["update_ms"] - out["epoch_ms"]) < 1e-9
    for stage in ("bmu", "stats", "epoch"):
        assert out[f"{stage}_method"] in ("slope(1,3)x2", "direct")
        assert out[f"{stage}_launches"] == {}  # the plain versions run on the CPU
    np.testing.assert_array_equal(som.get_weights().view(np.int64), w0.view(np.int64))
    state = som._random_generator.get_state()
    assert state[0] == rng0[0] and np.array_equal(state[1], rng0[1]) and state[2:] == rng0[2:]
    assert som._checkpoint_epoch == 5

