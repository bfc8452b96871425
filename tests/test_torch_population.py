"""The PyTorch port's ``SomPopulation`` on the CPU, against the JAX
package at the JAX tests' sizes (maps up to 6 x 5, P <= 3, n <= 400,
D = 8), inputs made with numpy from fixed seeds.

Tolerances: ``'batched'`` against JAX's ``'batched'`` after one epoch at
rtol 1e-5, atol 1e-6 (both an fp32 concatenated GEMM; only the summation
order differs); ``'serial'`` and ``'fused'`` against JAX's same strategy
after one epoch at the slice's rtol 1e-3, atol 1e-4 (the port searches
with the packed split, JAX's CPU path in fp32); several epochs by
quantization error at rtol 0.05 (``tests/test_population.py``'s
comparison discipline: near-tie winners separate trajectories between any
two formulations). Bitwise where the port's own design makes it so:
``'serial'`` against lone ``XPySom`` training, ``'fused'`` against
``'serial'``, streamed against resident, checkpoints across the packages.

The twins of ``tests/test_population.py`` keep its test names with a
``test_port_`` prefix."""

import pickle

import numpy as np
import pytest
import torch

from xpysom_dask_tpu import SomPopulation as JaxPop
from xpysom_dask_tpu_torch import SomPopulation, XPySom
from xpysom_dask_tpu_torch.models import population as port_population
from xpysom_dask_tpu_torch.parallel import ArraySource, FileSource, IterableSource

RTOL, ATOL = 1e-3, 1e-4  # the slice's one-epoch tolerance
CPU = dict(device="cpu")


def _blobs(n=240, d=8, seed=3):
    return np.random.RandomState(seed).rand(n, d).astype(np.float32)


def _pop(*args, **kw):
    return SomPopulation(*args, **CPU, **kw)


def _som(*args, **kw):
    return XPySom(*args, **CPU, **kw)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("seed", [11, [5, 5], [3, 8]])
def test_initial_codebooks_equal_jax_bitwise(seed):
    kw = dict(sigma=[1.0, 2.0], random_seed=seed)
    port_w = _pop(2, 6, 5, 8, **kw).weights
    assert port_w.shape == (2, 6, 5, 8)
    np.testing.assert_array_equal(_bits(port_w), _bits(JaxPop(2, 6, 5, 8, **kw).weights))


def test_one_epoch_batched_matches_jax():
    data = _blobs()
    kw = dict(sigma=[1.0, 2.0, 3.0], learning_rate=[0.5, 0.3, 0.7], random_seed=11)
    ours = _pop(3, 6, 5, 8, **kw).train(data, 3, iter_end=1, strategy="batched")
    ref = JaxPop(3, 6, 5, 8, **kw).train(data, 3, iter_end=1, strategy="batched")
    np.testing.assert_allclose(ours.weights, ref.weights, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strategy", ["serial", "fused"])
def test_one_epoch_matches_jax(strategy):
    data = _blobs()
    kw = dict(sigma=[1.0, 2.0, 3.0], learning_rate=[0.5, 0.3, 0.7], random_seed=11)
    ours = _pop(3, 6, 5, 8, **kw).train(data, 3, iter_end=1, strategy=strategy)
    ref = JaxPop(3, 6, 5, 8, **kw).train(data, 3, iter_end=1, strategy=strategy)
    np.testing.assert_allclose(ours.weights, ref.weights, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strategy", ["serial", "fused", "batched"])
def test_multi_epoch_qe_matches_jax(strategy):
    data = _blobs()
    kw = dict(sigma=[1.0, 1.5, 2.0], random_seed=9)
    ours = _pop(3, 6, 5, 8, **kw).train(data, 4, strategy=strategy)
    ref = JaxPop(3, 6, 5, 8, **kw).train(data, 4, strategy=strategy)
    np.testing.assert_allclose(ours.quantization_errors(data), ref.quantization_errors(data),
                               rtol=0.05)


def test_quantization_errors_match_jax():
    data = _blobs(n=300)
    ref = JaxPop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=4).train(data, 2)
    ours = SomPopulation.from_numpy(ref.weights, sigma=[1.0, 1.5, 2.0], **CPU)
    np.testing.assert_array_equal(ours.weights, ref.weights)
    np.testing.assert_allclose(ours.quantization_errors(data), ref.quantization_errors(data),
                               rtol=1e-5)
    np.testing.assert_allclose(ours.quantization_errors(ArraySource(data)),
                               ref.quantization_errors(data), rtol=1e-5)


NONDEFAULT = [
    dict(topology="hexagonal"),
    dict(neighborhood_function="mexican_hat"),
    dict(decay_function="linear"),
    dict(activation_distance="cosine"),
    dict(activation_distance="manhattan"),
    dict(neighborhood_function="bubble", compact_support=True),
]
NONDEFAULT_IDS = ["hex", "mexican_hat", "linear", "cosine", "manhattan", "bubble"]


@pytest.mark.parametrize("kw", NONDEFAULT, ids=NONDEFAULT_IDS)
def test_nondefault_one_epoch_matches_jax_and_lone_training(kw):
    """Twin of ``test_population_one_epoch_parity_nondefault``: the
    batched epoch matches the lone member's epoch to fp noise, and JAX's
    batched epoch."""
    data = _blobs(n=150)
    ours = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=13, **kw)
    ours.train(data, 2, iter_end=1, strategy="batched")
    ref = JaxPop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=13, **kw)
    ref.train(data, 2, iter_end=1, strategy="batched")
    np.testing.assert_allclose(ours.weights, ref.weights, rtol=1e-5, atol=1e-6)
    for i in range(2):
        lone = _som(5, 5, 8, sigma=[1.0, 2.0][i], random_seed=13 + i, **kw)
        lone.train(data, 2, iter_end=1)
        np.testing.assert_allclose(ours.member(i).get_weights(), lone.get_weights(),
                                   rtol=1e-5, atol=1e-6)


def test_checkpoints_cross_between_the_packages(tmp_path):
    data = _blobs(n=160)
    kw = dict(sigma=[1.0, 1.5, 2.0], learning_rate=[0.5, 0.4, 0.3], random_seed=7)
    jax_pop = JaxPop(3, 5, 4, 8, **kw).train(data, 4, iter_end=2)
    for m in jax_pop.members:
        m._random_generator.rand(3)  # move the streams off their seeds
    jax_pop.save_checkpoint(tmp_path / "jax.npz", epoch=2)
    ours = SomPopulation.load_checkpoint(tmp_path / "jax.npz", **CPU)
    assert ours._checkpoint_epoch == 2 and ours.n_members == 3
    np.testing.assert_array_equal(_bits(ours.weights), _bits(jax_pop.weights))
    assert [m._sigma for m in ours.members] == [1.0, 1.5, 2.0]
    assert [m._learning_rate for m in ours.members] == [0.5, 0.4, 0.3]
    for a, b in zip(ours.members, jax_pop.members):
        sa, sb = a._random_generator.get_state(), b._random_generator.get_state()
        np.testing.assert_array_equal(sa[1], sb[1])
        assert sa[2:] == sb[2:]

    ours.train(data, 4, iter_beg=ours._checkpoint_epoch)
    ours.save_checkpoint(tmp_path / "port.npz", epoch=4)
    back = JaxPop.load_checkpoint(tmp_path / "port.npz")
    assert back._checkpoint_epoch == 4
    np.testing.assert_array_equal(_bits(back.weights), _bits(ours.weights))
    for a, b in zip(back.members, ours.members):
        np.testing.assert_array_equal(a._random_generator.rand(5), b._random_generator.rand(5))
    assert [m._bmu_precision for m in back.members] == [m._bmu_precision for m in ours.members]


# -- the port's own bitwise properties ----------------------------------------


def test_fused_equals_serial_bitwise():
    data = _blobs(n=220)
    kw = dict(sigma=[1.0, 1.5, 2.0], learning_rate=[0.5, 0.3, 0.7], random_seed=7)
    serial = _pop(3, 5, 5, 8, **kw).train(data, 4, strategy="serial")
    fused = _pop(3, 5, 5, 8, **kw).train(data, 4, strategy="fused")
    np.testing.assert_array_equal(_bits(fused.weights), _bits(serial.weights))


@pytest.mark.parametrize("strategy", ["fused", "batched"])
def test_streamed_equals_resident_bitwise(strategy):
    """Superbatches of whole chunks give the resident chunks, and the
    running statistics add their partials in the resident order."""
    data = _blobs(n=400)
    kw = dict(sigma=[1.0, 2.0], random_seed=9, n_parallel=80)
    resident = _pop(2, 5, 5, 8, **kw).train(data, 3, strategy=strategy)
    streamed = _pop(2, 5, 5, 8, **kw)
    streamed._superbatch_rows = lambda: 160  # two chunks, a ragged last superbatch
    streamed.train(ArraySource(data), 3, strategy=strategy)
    np.testing.assert_array_equal(_bits(streamed.weights), _bits(resident.weights))


def test_mesh_raises_naming_data_parallel():
    """The JAX mesh tests' counterpart: a grid mesh raises with the JAX
    package's message; a data mesh trains (across processes:
    ``tests/test_torch_distributed.py``), here a world of one, bit for bit
    the population without a mesh."""
    with pytest.raises(ValueError, match="1-D data-parallel meshes only"):
        _pop(2, 4, 4, 6, mesh=(1, 2))
    data = _blobs(n=200)
    kw = dict(sigma=[1.0, 2.0], random_seed=4)
    meshed = _pop(2, 4, 4, 8, mesh="auto", **kw).train(data, 2)
    plain = _pop(2, 4, 4, 8, **kw).train(data, 2)
    np.testing.assert_array_equal(_bits(meshed.weights), _bits(plain.weights))


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SomPopulation(2, 4, 4, 3)
    pop = _pop(2, 4, 4, 3, random_seed=0)
    assert all(m._device.type == "cpu" for m in pop.members)


def test_pickle_keeps_the_device_as_given():
    pop = _pop(2, 4, 4, 3, random_seed=0)
    pop._resolved_device = torch.device("cuda")  # as on a host with a card
    clone = pickle.loads(pickle.dumps(pop))
    assert clone._resolved_device is None and clone._device.type == "cpu"


def test_from_numpy_carries_weights():
    w = np.random.RandomState(0).rand(3, 4, 5, 6).astype(np.float32)
    pop = SomPopulation.from_numpy(w, sigma=1.0, **CPU)
    assert pop.n_members == 3 and pop.weights.shape == (3, 4, 5, 6)
    np.testing.assert_array_equal(pop.weights, w)
    with pytest.raises(ValueError, match="weights expected"):
        SomPopulation.from_numpy(w[0], **CPU)


def test_streaming_auto_gate_routes_measured_rows(monkeypatch):
    """Both sweeps measured on the card (16 x 24x24 and 4 x 128x128 maps)
    ran streamed 'fused' faster than 'batched' (the comment at the top of
    the module), so streamed 'auto' runs 'fused' at every size: it never
    builds the concatenated statistics, and it gives fused's bits."""
    data = _blobs(n=240)
    kw = dict(sigma=[1.0, 2.0], random_seed=3)
    fused = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 2, strategy="fused")

    def refuse(specs):
        raise AssertionError("streamed 'auto' built the 'batched' statistics")

    monkeypatch.setattr(port_population, "_make_pop_stats", refuse)
    auto = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 2)
    np.testing.assert_array_equal(_bits(auto.weights), _bits(fused.weights))


# -- twins of tests/test_population.py -------------------------------------------


def test_port_population_one_epoch_matches_serial_bitwise_class():
    data = _blobs()
    sigmas, lrs = [1.0, 2.0, 3.0], [0.5, 0.3, 0.7]
    pop = _pop(3, 6, 5, 8, sigma=sigmas, learning_rate=lrs, random_seed=11)
    pop.train(data, 3, iter_beg=0, iter_end=1, strategy="batched")
    for i in range(3):
        ref = _som(6, 5, 8, sigma=sigmas[i], learning_rate=lrs[i], random_seed=11 + i)
        ref.train(data, 3, iter_beg=0, iter_end=1)
        np.testing.assert_allclose(pop.member(i).get_weights(), ref.get_weights(),
                                   rtol=1e-6, atol=1e-7)


def test_port_population_quantization_errors_match_members():
    data = _blobs(n=180)
    pop = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=4)
    pop.train(data, 2)
    qes = pop.quantization_errors(data)
    assert qes.shape == (3,)
    for i in range(3):
        assert qes[i] == pytest.approx(pop.member(i).quantization_error(data), rel=1e-4)


def test_port_best_returns_lowest_qe_member():
    data = _blobs(n=200)
    pop = _pop(3, 5, 5, 8, learning_rate=[0.9, 0.5, 0.01], random_seed=7)
    pop.train(data, 3)
    qes = pop.quantization_errors(data)
    best = pop.best(data)
    assert best is pop.member(int(np.argmin(qes)))
    assert best.predict(data[:5]).shape == (5,)
    assert best.quantization(data[:5]).shape == (5, 8)


def test_port_per_member_hyperparams_flow():
    data = _blobs(n=160)
    pop = _pop(2, 6, 6, 8, sigma=[0.5, 3.0], random_seed=[5, 5])
    np.testing.assert_array_equal(pop.member(0).get_weights(), pop.member(1).get_weights())
    pop.train(data, 2)
    assert not np.allclose(pop.member(0).get_weights(), pop.member(1).get_weights())


def test_port_seed_broadcast_and_validation():
    w = _pop(3, 4, 4, 6, random_seed=9).weights
    assert w.shape == (3, 4, 4, 6)
    assert not np.allclose(w[0], w[1]) and not np.allclose(w[1], w[2])
    with pytest.raises(ValueError, match="length-3"):
        _pop(3, 4, 4, 6, sigma=[1.0, 2.0])
    with pytest.raises(ValueError, match="n_members"):
        _pop(0, 4, 4, 6)
    with pytest.raises(ValueError):
        _pop(2, 4, 4, 6, neighborhood_function="nope")


def test_port_population_iter_segments_compose():
    """[0, 1) then [1, 3) equals one [0, 3) run bit for bit (one loop)."""
    data = _blobs(n=140)
    kw = dict(sigma=[1.0, 2.0], random_seed=6)
    pop_a = _pop(2, 5, 5, 8, **kw).train(data, 3)
    pop_b = _pop(2, 5, 5, 8, **kw)
    pop_b.train(data, 3, iter_beg=0, iter_end=1)
    pop_b.train(data, 3, iter_beg=1, iter_end=3)
    np.testing.assert_array_equal(_bits(pop_a.weights), _bits(pop_b.weights))


def test_port_population_pickle_roundtrip():
    data = _blobs(n=120)
    pop = _pop(2, 4, 4, 8, sigma=[1.0, 2.0], random_seed=8).train(data, 2)
    clone = pickle.loads(pickle.dumps(pop))
    np.testing.assert_array_equal(clone.weights, pop.weights)
    np.testing.assert_array_equal(clone.quantization_errors(data), pop.quantization_errors(data))


def test_port_member_init_flows_into_population_training():
    data = _blobs(n=160)
    pop = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=3)
    pop.member(0).pca_weights_init(data)
    w_init = pop.weights.copy()
    pop.train(data, 3, iter_beg=0, iter_end=0)  # zero epochs: passthrough
    np.testing.assert_array_equal(pop.weights, w_init)
    pop.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")
    ref = _som(5, 5, 8, sigma=1.0, random_seed=3)
    ref.pca_weights_init(data)
    ref.train(data, 2, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(pop.member(0).get_weights(), ref.get_weights(),
                               rtol=1e-5, atol=1e-6)


def test_port_population_single_member_degenerate():
    data = _blobs(n=100)
    pop = _pop(1, 5, 5, 8, sigma=1.5, random_seed=21)
    pop.train(data, 2, iter_beg=0, iter_end=1, strategy="batched")
    ref = _som(5, 5, 8, sigma=1.5, random_seed=21).train(data, 2, iter_beg=0, iter_end=1)
    np.testing.assert_allclose(pop.member(0).get_weights(), ref.get_weights(),
                               rtol=1e-6, atol=1e-7)


def test_port_population_periodic_checkpointing(tmp_path):
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_periodic.npz"
    full = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=11).train(data, 6)
    ck = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=11)
    ck.train(data, 6, checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_array_equal(_bits(ck.weights), _bits(full.weights))
    loaded = SomPopulation.load_checkpoint(ckpt, **CPU)
    assert loaded._checkpoint_epoch == 6 and loaded.n_members == 3
    np.testing.assert_array_equal(loaded.weights, ck.weights)
    assert [m._sigma for m in loaded.members] == [1.0, 1.5, 2.0]


def test_port_population_checkpoint_resume_matches_uninterrupted(tmp_path):
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_resume.npz"
    full = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5).train(data, 6)
    part = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    part.train(data, 6, iter_beg=0, iter_end=3)
    part.save_checkpoint(ckpt, epoch=3)
    resumed = SomPopulation.load_checkpoint(ckpt, **CPU)
    resumed.train(data, 6, iter_beg=resumed._checkpoint_epoch)
    np.testing.assert_array_equal(_bits(resumed.weights), _bits(full.weights))
    for a, b in zip(resumed.members, part.members):
        np.testing.assert_array_equal(a._random_generator.rand(4), b._random_generator.rand(4))


def test_port_population_checkpoint_rejects_single_model_file(tmp_path):
    _som(4, 4, 8, random_seed=1).save_checkpoint(tmp_path / "single.npz")
    with pytest.raises(ValueError, match="single-model"):
        SomPopulation.load_checkpoint(tmp_path / "single.npz", **CPU)
    _pop(2, 4, 4, 8, random_seed=1).save_checkpoint(tmp_path / "pop.npz")
    with pytest.raises((ValueError, KeyError)):
        XPySom.load_checkpoint(tmp_path / "pop.npz", **CPU)


def test_port_population_streaming_matches_resident(tmp_path):
    data = _blobs(n=400)
    kw = dict(sigma=[1.0, 2.0], random_seed=9)
    resident = _pop(2, 5, 5, 8, **kw).train(data, 3)
    streamed = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 3)
    np.testing.assert_allclose(streamed.weights, resident.weights, rtol=1e-4, atol=1e-5)
    data.tofile(tmp_path / "pop.f32")
    mm = np.memmap(tmp_path / "pop.f32", dtype=np.float32, mode="r", shape=(400, 8))
    streamed2 = _pop(2, 5, 5, 8, **kw).train(mm, 3)
    np.testing.assert_allclose(streamed2.weights, resident.weights, rtol=1e-4, atol=1e-5)

    def factory():
        for start in range(0, 400, 77):
            yield data[start : start + 77]

    streamed3 = _pop(2, 5, 5, 8, **kw).train(IterableSource(factory, 400, 8), 3)
    np.testing.assert_allclose(streamed3.weights, resident.weights, rtol=1e-4, atol=1e-5)


def test_port_population_streaming_checkpoint_and_validation(tmp_path):
    data = _blobs(n=200)
    ckpt = tmp_path / "pop_stream.npz"
    pop = _pop(2, 4, 4, 8, random_seed=3)
    pop.train(ArraySource(data), 4, checkpoint_path=ckpt, checkpoint_every=2)
    loaded = SomPopulation.load_checkpoint(ckpt, **CPU)
    assert loaded._checkpoint_epoch == 4
    np.testing.assert_array_equal(loaded.weights, pop.weights)
    with pytest.raises(ValueError, match="features"):
        _pop(2, 4, 4, 6, random_seed=3).train(ArraySource(data), 1)
    with pytest.raises(ValueError, match="empty"):
        _pop(2, 4, 4, 8, random_seed=3).train(ArraySource(np.zeros((0, 8), np.float32)), 1)


def test_port_population_checkpoint_preserves_member_kernel_config(tmp_path, monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "highest")
    pop = _pop(2, 4, 4, 8, random_seed=3)
    assert all(m._bmu_precision == "highest" for m in pop.members)
    pop.save_checkpoint(tmp_path / "pop_cfg.npz", epoch=1)
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    loaded = SomPopulation.load_checkpoint(tmp_path / "pop_cfg.npz", **CPU)
    assert all(m._bmu_precision == "highest" for m in loaded.members)
    assert all(s.bmu_precision == "highest" for s in loaded._specs())


def test_port_population_best_empty_raises():
    pop = _pop(2, 4, 4, 8, random_seed=0)
    with pytest.warns(UserWarning, match="empty"):
        with pytest.raises(ValueError, match="empty"):
            pop.best(np.zeros((0, 8), np.float32))


def test_port_population_quantization_errors_streams_sources(tmp_path):
    data = _blobs(n=300)
    pop = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=4).train(data, 2)
    resident = pop.quantization_errors(data)
    np.testing.assert_allclose(pop.quantization_errors(ArraySource(data)), resident, rtol=1e-6)
    data.tofile(tmp_path / "pop_qe.f32")
    np.testing.assert_allclose(
        pop.quantization_errors(FileSource(str(tmp_path / "pop_qe.f32"), 300, 8)), resident,
        rtol=1e-6)
    mm = np.memmap(tmp_path / "pop_qe.f32", dtype=np.float32, mode="r", shape=(300, 8))
    np.testing.assert_allclose(pop.quantization_errors(mm), resident, rtol=1e-6)
    assert pop.best(ArraySource(data)) is pop.member(int(np.argmin(resident)))
    with pytest.raises(ValueError, match="features"):
        pop.quantization_errors(np.zeros((10, 5), np.float32))
    with pytest.raises(ValueError, match="features"):
        pop.quantization_errors(ArraySource(np.zeros((10, 5), np.float32)))


def test_port_population_train_rejects_negative_checkpoint_every(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every"):
        _pop(2, 4, 4, 8, random_seed=1).train(_blobs(n=50), 2, checkpoint_path=tmp_path / "x",
                                             checkpoint_every=-2)


def test_port_population_empty_verbose_does_not_crash(capsys):
    pop = _pop(2, 4, 4, 8, random_seed=1)
    with pytest.warns(UserWarning, match="empty"):
        pop.train(np.zeros((0, 8), np.float32), 2, verbose=True)
    capsys.readouterr()


def test_port_population_serial_bitwise_matches_individual_training():
    data = _blobs(n=220)
    sigmas, lrs = [1.0, 2.0, 3.0], [0.5, 0.3, 0.7]
    pop = _pop(3, 6, 5, 8, sigma=sigmas, learning_rate=lrs, random_seed=11)
    pop.train(data, 3, strategy="serial")
    for i in range(3):
        ref = _som(6, 5, 8, sigma=sigmas[i], learning_rate=lrs[i], random_seed=11 + i)
        ref.train(data, 3)
        np.testing.assert_array_equal(_bits(pop.member(i).get_weights()), _bits(ref.get_weights()))
    assert pop.member(0)._n_parallel == _som(6, 5, 8)._n_parallel


def test_port_population_explicit_n_parallel_reaches_members_and_serial():
    data = _blobs(n=220)
    pop = _pop(2, 6, 5, 8, random_seed=3, n_parallel=64)
    assert pop.member(0)._n_parallel == 64 and pop.member(0)._n_parallel_explicit
    pop.train(data, 2, strategy="serial")
    for i in range(2):
        ref = _som(6, 5, 8, random_seed=3 + i, n_parallel=64).train(data, 2)
        np.testing.assert_array_equal(_bits(pop.member(i).get_weights()), _bits(ref.get_weights()))


def test_port_population_auto_is_serial_for_resident_data():
    data = _blobs(n=150)
    a = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=4).train(data, 2)
    b = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=4).train(data, 2, strategy="serial")
    np.testing.assert_array_equal(_bits(a.weights), _bits(b.weights))


def test_port_population_strategy_validation(tmp_path):
    data = _blobs(n=64)
    pop = _pop(2, 4, 4, 8, random_seed=1)
    with pytest.raises(ValueError, match="strategy"):
        pop.train(data, 1, strategy="fastest")
    mm = np.memmap(tmp_path / "x.dat", dtype=np.float32, mode="w+", shape=(64, 8))
    mm[:] = data
    mm.flush()
    with pytest.raises(ValueError, match="serial"):
        pop.train(mm, 1, strategy="serial")
    pop.train(mm, 1)  # auto on a source routes a one-pass strategy


def test_port_population_serial_checkpoint_resume(tmp_path):
    data = _blobs(n=160)
    ckpt = tmp_path / "pop_serial.npz"
    full = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5).train(data, 6, strategy="serial")
    ck = _pop(2, 5, 5, 8, sigma=[1.0, 2.0], random_seed=5)
    ck.train(data, 6, strategy="serial", checkpoint_path=ckpt, checkpoint_every=3)
    np.testing.assert_array_equal(ck.weights, full.weights)
    resumed = SomPopulation.load_checkpoint(ckpt, **CPU)
    assert resumed._checkpoint_epoch == 6
    np.testing.assert_array_equal(resumed.weights, full.weights)


def test_port_population_fused_matches_serial_one_epoch():
    data = _blobs(n=220)
    a = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=7).train(data, 1, strategy="serial")
    b = _pop(3, 5, 5, 8, sigma=[1.0, 1.5, 2.0], random_seed=7).train(data, 1, strategy="fused")
    np.testing.assert_array_equal(_bits(a.weights), _bits(b.weights))
    a.train(data, 4, strategy="serial")
    b.train(data, 4, strategy="fused")
    np.testing.assert_allclose(a.quantization_errors(data), b.quantization_errors(data), rtol=0.05)


def test_port_population_streaming_fused_and_batched_parity():
    data = _blobs(n=300)
    kw = dict(sigma=[1.0, 2.0], random_seed=11)
    auto = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 3)
    fused = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 3, strategy="fused")
    np.testing.assert_array_equal(auto.weights, fused.weights)
    resident = _pop(2, 5, 5, 8, **kw).train(data, 3, strategy="fused")
    np.testing.assert_allclose(fused.weights, resident.weights, rtol=1e-4, atol=1e-5)
    batched = _pop(2, 5, 5, 8, **kw).train(ArraySource(data), 3, strategy="batched")
    np.testing.assert_allclose(batched.quantization_errors(data), fused.quantization_errors(data),
                               rtol=0.05)


@pytest.mark.parametrize("strategy", ["serial", "fused", "batched"])
def test_port_population_verbose_paths(strategy, capsys, tmp_path):
    """The verbose bar and QE line, checkpoints written on that path, and
    a streamed verbose sweep (``test_population.py:188, 305, 466, 596``)."""
    data = _blobs(n=120)
    ckpt = tmp_path / "pop_verbose.npz"
    pop = _pop(2, 4, 4, 8, sigma=1.0, random_seed=2)
    pop.train(data, 3, verbose=True, checkpoint_path=ckpt, checkpoint_every=1, strategy=strategy)
    assert "quantization errors" in capsys.readouterr().out
    loaded = SomPopulation.load_checkpoint(ckpt, **CPU)
    assert loaded._checkpoint_epoch == 3
    np.testing.assert_array_equal(loaded.weights, pop.weights)
    if strategy != "serial":
        pop.train(ArraySource(data), 2, verbose=True, strategy=strategy)
        assert "quantization errors" in capsys.readouterr().out
