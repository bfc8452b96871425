"""The PyTorch port's training/scoring slice against the JAX package and
the float64 golden model, on the CPU at small sizes. Inputs are made with
numpy from fixed seeds and handed to both packages."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu.models.golden import GoldenSom
from xpysom_dask_tpu.ops import decays as jdecays
from xpysom_dask_tpu.ops import neighborhoods as jnb
from xpysom_dask_tpu.utils import hw as jhw
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch import core as tcore
from xpysom_dask_tpu_torch.ops import decays as tdecays
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops import neighborhoods as tnb
from xpysom_dask_tpu_torch.utils import hw as thw


@pytest.mark.parametrize("name", ["exponential", "asymptotic", "linear"])
@pytest.mark.parametrize("val0,valN,T", [(0.5, 0.01, 10), (3.0, 0.0, 7), (2.0, 1.0, 1)])
def test_decays_match_jax(name, val0, valN, T):
    for t in range(T):
        got = tdecays.DECAY_REGISTRY[name](val0, valN, t, T)
        want = jdecays.DECAY_REGISTRY[name](val0, valN, jnp.int32(t), T)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_make_decay_rejects_unknown():
    with pytest.raises(ValueError, match="not supported"):
        tdecays.make_decay("cubic")


@pytest.mark.parametrize("name", ["gaussian", "mexican_hat", "bubble", "triangle"])
@pytest.mark.parametrize("compact", [False, True])
def test_neighborhood_operator_and_apply_match_jax(name, compact):
    x, y, d = 7, 5, 6
    sigma = 2.3
    rng = np.random.RandomState(3)
    s = rng.rand(x * y, d).astype(np.float32)
    cnt = rng.randint(0, 9, x * y).astype(np.float32)
    xx, yy = tcore.grid_coordinates(x, y, "rectangular")
    jop = jnb.neighborhood_operator(
        name, "rectangular", jnp.arange(x, dtype=jnp.float32),
        jnp.arange(y, dtype=jnp.float32), jnp.asarray(xx, jnp.float32),
        jnp.asarray(yy, jnp.float32), 0.7, compact, jnp.float32(sigma),
    )
    top = tnb.neighborhood_operator(
        name, "rectangular", torch.arange(x, dtype=torch.float32),
        torch.arange(y, dtype=torch.float32), 0.7, compact,
        torch.tensor(sigma, dtype=torch.float32),
    )
    assert len(top[1]) == len(jop[1])
    for (tax, tay), (jax_, jay) in zip(top[1], jop[1]):
        np.testing.assert_allclose(tax.numpy(), np.asarray(jax_), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tay.numpy(), np.asarray(jay), rtol=1e-6, atol=1e-6)
    num, den = tnb.apply_operator(top, torch.from_numpy(s), torch.from_numpy(cnt))
    jnum, jden = jnb.apply_operator(jop, jnp.asarray(s), jnp.asarray(cnt))
    # 1e-6 of each array's scale: mexican-hat terms cancel, and the two
    # einsum chains sum in different orders
    for mine, ref in ((num, jnum), (den, jden)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            mine.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max()
        )


def test_hw_sizing_matches_jax():
    for n, cap in [(5, 16384), (1000, 16384), (70000, 16384), (3000, 1500), (9, 4)]:
        assert thw.training_chunk(n, cap) == jhw.training_chunk(n, cap)
        assert thw.inference_chunk(n, cap) == jhw.inference_chunk(n, cap)
    for xy in (30, 4000, 16384):
        assert thw.default_n_parallel(xy, "cpu") == jhw.default_n_parallel(xy, "cpu")
    assert thw.default_n_parallel(16384, "cuda", fused=True) == 16384
    assert thw.default_n_parallel(16384, "cuda") == jhw.default_n_parallel(16384, "gpu")


def _pair(x, y, d, seed, **kw):
    ours = XPySom(x, y, d, random_seed=seed, device="cpu", **kw)
    ref = JaxSom(x, y, d, random_seed=seed, **kw)
    gold = GoldenSom(
        x, y, d, sigma=kw.get("sigma", 0), sigmaN=kw.get("sigmaN", 1),
        learning_rate=kw.get("learning_rate", 0.5),
        learning_rateN=kw.get("learning_rateN", 0.01),
        decay=kw.get("decay_function", "exponential"),
        neighborhood=kw.get("neighborhood_function", "gaussian"),
        std_coeff=kw.get("std_coeff", 0.5),
        compact_support=kw.get("compact_support", False), random_seed=seed,
    )
    np.testing.assert_array_equal(ours.get_weights(), ref.get_weights())
    np.testing.assert_array_equal(ours.get_weights(), gold.weights)
    return ours, ref, gold


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"neighborhood_function": "mexican_hat"},
        {"decay_function": "linear"},
        {"decay_function": "asymptotic", "std_coeff": 1.3},
        {"n_parallel": 64},  # several chunks per epoch
    ],
)
def test_train_matches_jax_and_golden(kw):
    rng = np.random.RandomState(11)
    data = rng.rand(300, 4).astype(np.float32)
    ours, ref, gold = _pair(6, 5, 4, 42, **kw)
    for som in (ours, ref, gold):
        som.train(data, 5)
    np.testing.assert_allclose(ours.get_weights(), ref.get_weights(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours.get_weights(), gold.weights, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        ours.quantization_error(data), gold.quantization_error(data), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        ours.quantization_error(data), ref.quantization_error(data), rtol=1e-5, atol=1e-6
    )
    assert ours.topographic_error(data) == ref.topographic_error(data)
    assert ours.winner(data) == ref.winner(data)
    np.testing.assert_array_equal(ours.predict(data), gold.bmu(data))


def test_segmented_training_composes():
    rng = np.random.RandomState(4)
    data = rng.rand(200, 3).astype(np.float32)
    whole = XPySom(5, 4, 3, random_seed=1, device="cpu").train(data, 6)
    seg = XPySom(5, 4, 3, random_seed=1, device="cpu")
    seg.train(data, 6, iter_end=2).train(data, 6, iter_beg=2, iter_end=6)
    np.testing.assert_array_equal(whole.get_weights(), seg.get_weights())


def test_plain_and_kernel_routes_agree_on_cpu():
    """use_kernels=False selects the plain versions explicitly; on CPU
    tensors the kernel wrappers run the same plain versions."""
    rng = np.random.RandomState(2)
    data = rng.rand(150, 5).astype(np.float32)
    a = XPySom(4, 4, 5, random_seed=3, device="cpu").train(data, 3)
    b = XPySom(4, 4, 5, random_seed=3, device="cpu", use_kernels=False).train(data, 3)
    np.testing.assert_array_equal(a.get_weights(), b.get_weights())


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"activation_distance": "manhattan"},
        {"activation_distance": "norm_p", "activation_distance_kwargs": {"p": 4}},
    ],
    ids=["euclidean", "manhattan", "norm_p4"],
)
def test_from_numpy_round_trips_a_jax_codebook(kw):
    """Both packages score the same (JAX-trained) codebook: equal winners
    and QE, and the same continued training."""
    rng = np.random.RandomState(8)
    data = rng.rand(250, 4).astype(np.float32)
    ref = JaxSom(6, 5, 4, random_seed=5, **kw)
    ref.train(data, 6, iter_end=3)
    ours = XPySom.from_numpy(ref._weights, random_seed=5, device="cpu", **kw)
    np.testing.assert_array_equal(ours.get_weights(), ref._weights)
    assert isinstance(ours.get_weights(), np.ndarray)
    np.testing.assert_array_equal(ours.predict(data), ref.predict(data))
    np.testing.assert_allclose(
        ours.quantization_error(data), ref.quantization_error(data), rtol=1e-5
    )
    ref.train(data, 6, iter_beg=3, iter_end=6)
    ours.train(data, 6, iter_beg=3, iter_end=6)
    np.testing.assert_allclose(ours.get_weights(), ref._weights, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError, match="X, Y, D"):
        XPySom.from_numpy(np.zeros((4, 3)))


def test_init_helpers_match_jax():
    rng = np.random.RandomState(0)
    data = rng.rand(100, 4)
    for method in ("random_weights_init", "pca_weights_init"):
        ours = XPySom(5, 6, 4, random_seed=9, device="cpu")
        ref = JaxSom(5, 6, 4, random_seed=9)
        getattr(ours, method)(data)
        getattr(ref, method)(data)
        np.testing.assert_array_equal(ours.get_weights(), ref.get_weights())


def test_launch_counters_stay_zero_after_cpu_training():
    kernels.reset_launch_counts()
    data = np.random.RandomState(1).rand(80, 3).astype(np.float32)
    som = XPySom(4, 4, 3, random_seed=0, device="cpu").train(data, 2)
    som.quantization_error(data)
    som.topographic_error(data)
    for kw in ({"activation_distance": "manhattan"}, {"bmu_precision": "highest"}):
        XPySom(4, 4, 3, random_seed=0, device="cpu", **kw).train(data, 1)
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_edge_contracts():
    som = XPySom(4, 4, 3, random_seed=0, device="cpu")
    with pytest.raises(ValueError, match="Received 2 features"):
        som.winner(np.zeros((3, 2), np.float32))
    with pytest.warns(UserWarning, match="no rows"):
        assert np.isnan(som.quantization_error(np.zeros((0, 3), np.float32)))
    assert som.predict(np.zeros((0, 3), np.float32)).shape == (0,)
    assert som.winner(np.zeros(3, np.float32)) == som.winner(np.zeros((1, 3)))[0]
    with pytest.warns(UserWarning, match="1-by-1"):
        assert np.isnan(XPySom(1, 1, 3, device="cpu").topographic_error(np.zeros((4, 3))))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"topology": "hexagonal"},
        {"bmu_precision": "split3"},
        {"bmu_precision": "bf16"},
        {"use_dask": True},
    ],
)
def test_unported_options_raise(kwargs):
    """Hexagonal grids, every precision mode and data-parallel training are
    served: ``use_dask=True`` maps to ``mesh='auto'`` with the JAX
    package's warning, whatever the other options (a world of one here);
    a (data, model) grid mesh is served too, and in a world of one a grid
    of four raises naming the processes to start
    (``tests/test_torch_grid_sharded.py`` runs grids across processes)."""
    XPySom(4, 4, 3, device="cpu", **{k: v for k, v in kwargs.items() if k != "use_dask"})
    with pytest.warns(UserWarning, match="use_dask is deprecated: mapping to mesh='auto'"):
        som = XPySom(4, 4, 3, device="cpu", **dict(kwargs, use_dask=True))
    assert som._mesh.world == 1
    assert XPySom(4, 4, 3, device="cpu", mesh=(1, 1), **kwargs)._mesh.n_model == 1
    with pytest.raises(ValueError, match="needs 4 processes and its process group has 1"):
        XPySom(4, 4, 3, device="cpu", mesh=(2, 2), **kwargs)


def test_unported_methods_and_inputs_raise(tmp_path, capsys):
    """What ROADMAP Queue 1 items 7 and 9 ported now runs (checkpoints,
    ``verbose``, ``get_neig_functions``, ``autotune_kernel``, a streamed
    source); so does codebook sharding (item 11), whose grid must have
    its processes."""
    from xpysom_dask_tpu_torch.parallel.pipeline import ArraySource

    som = XPySom(4, 4, 3, device="cpu")
    data = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    with pytest.raises(ValueError, match="not recognized"):
        XPySom(4, 4, 3, device="cpu", bmu_precision="fast")
    assert set(som.get_neig_functions()) == {"gaussian", "mexican_hat", "bubble", "triangle"}
    with pytest.warns(UserWarning, match="nothing to tune"):
        assert som.autotune_kernel() is None
    som.save_checkpoint(tmp_path / "ck.npz")
    assert XPySom.load_checkpoint(tmp_path / "ck.npz", device="cpu")._checkpoint_epoch == 0
    som.train(data, 2, verbose=True)
    assert "quantization error" in capsys.readouterr().out
    som.train(data, 2, checkpoint_path=tmp_path / "ck.npz", checkpoint_every=1)
    assert XPySom.load_checkpoint(tmp_path / "ck.npz", device="cpu")._checkpoint_epoch == 2
    np.testing.assert_array_equal(som.predict(ArraySource(data)), som.predict(data))
    with pytest.raises(ValueError, match="needs 2 processes.*torchrun --nproc-per-node=2"):
        XPySom(4, 4, 3, device="cpu", mesh=(1, 2))


def test_port_never_imports_jax(tmp_path):
    code = (
        "import sys, numpy as np, xpysom_dask_tpu_torch, xpysom_dask_tpu_torch.core, "
        "xpysom_dask_tpu_torch.ops.kernels.build, xpysom_dask_tpu_torch.parallel, "
        "xpysom_dask_tpu_torch.utils.serialization, xpysom_dask_tpu_torch.utils.native, "
        "xpysom_dask_tpu_torch.utils.profiling, xpysom_dask_tpu_torch.utils.progress; "
        "from xpysom_dask_tpu_torch.parallel import ArraySource; "
        "d = np.random.RandomState(0).rand(64, 3).astype(np.float32); "
        "[xpysom_dask_tpu_torch.XPySom(3, 3, 3, device='cpu', activation_distance=a, "
        "activation_distance_kwargs=k).train(d, 1).quantization_error(d) for a, k in "
        "(('manhattan', {}), ('cosine', {}), ('norm_p', {'p': 1.5}), ('norm_p', {'p': 4}))]; "
        "s = xpysom_dask_tpu_torch.XPySom(3, 3, 3, device='cpu').train(ArraySource(d), 1); "
        "s.get_neig_functions(); s.save_checkpoint(sys.argv[1]); "
        "xpysom_dask_tpu_torch.XPySom.load_checkpoint(sys.argv[1], device='cpu'); "
        "from xpysom_dask_tpu_torch import SomPopulation; "
        "p = SomPopulation(2, 3, 3, 3, device='cpu', sigma=[1.0, 2.0], random_seed=0); "
        "[p.train(d, 2, strategy=st) for st in ('serial', 'fused', 'batched')]; "
        "p.train(ArraySource(d), 1); p.best(d); p.save_checkpoint(sys.argv[1]); "
        "SomPopulation.load_checkpoint(sys.argv[1], device='cpu').quantization_errors(d); "
        "from xpysom_dask_tpu_torch.sklearn import SomClusterer; "
        "SomClusterer(3, 3, num_epochs=1, device='cpu').fit(d).transform(d); "
        "from xpysom_dask_tpu_torch.utils.profiling import epoch_anatomy; "
        "epoch_anatomy(s, d, lo=1, hi=2, reps=1); "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ck.npz")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_profile_epoch_needs_a_card_and_merges_intervals(monkeypatch):
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    path = Path(__file__).resolve().parents[1] / "profile_torch_epoch.py"
    spec = importlib.util.spec_from_file_location("profile_torch_epoch", path)
    profile_epoch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_epoch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        profile_epoch.main([])
    ev = [SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))
          for s, e in [(0, 10), (5, 12), (20, 25)]]
    assert profile_epoch._busy_us(ev) == (17, 25)
    assert profile_epoch._busy_us([]) == (0, 0)
