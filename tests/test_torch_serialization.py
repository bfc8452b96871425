"""The PyTorch port's checkpoints, pickling, ``verbose``,
``get_neig_functions`` and ``autotune_kernel`` on the CPU, against the JAX
package at small sizes: twins of ``tests/test_pipeline_serialization.py``'s
checkpoint tests, checkpoints crossing between the packages both ways, a
pickle made on a host with a card loaded on one without, the progress bar
and QE line against JAX's, and the neighborhood callables against JAX's
one by one. Inputs are made with numpy from fixed seeds."""

import io
import pickle
import re

import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu.utils import progress as jax_progress
from xpysom_dask_tpu.utils import serialization as jax_serialization
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import progress as port_progress
from xpysom_dask_tpu_torch.utils.serialization import load_checkpoint

# the JAX golden-parity tolerance (tests/test_training_parity.py)
RTOL, ATOL = 1e-3, 1e-4


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    data = np.random.RandomState(4).rand(256, 3).astype(np.float32)
    full = XPySom(5, 4, 3, sigma=1.5, random_seed=7, device="cpu").train(data, 6)
    half = XPySom(5, 4, 3, sigma=1.5, random_seed=7, device="cpu")
    half.train(data, 6, iter_beg=0, iter_end=3)
    ckpt = tmp_path / "som.npz"
    half.save_checkpoint(ckpt, epoch=3)

    resumed = XPySom.load_checkpoint(ckpt, device="cpu")
    assert resumed._checkpoint_epoch == 3
    np.testing.assert_array_equal(resumed._weights, half._weights)
    resumed.train(data, 6, iter_beg=3, iter_end=6)
    # the resident epochs are one Python loop either way: bit for bit
    np.testing.assert_array_equal(_bits(resumed._weights), _bits(full._weights))


def test_checkpoint_without_epoch_resumes_from_zero(tmp_path):
    som = XPySom(4, 4, 2, random_seed=11, device="cpu")
    ckpt = tmp_path / "noepoch.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt, device="cpu")
    assert loaded._checkpoint_epoch == 0
    data = np.random.RandomState(1).rand(32, 2).astype(np.float32)
    loaded.train(data, 2, iter_beg=loaded._checkpoint_epoch)


def test_checkpoint_preserves_rng_stream(tmp_path):
    som = XPySom(4, 4, 2, random_seed=9, device="cpu")
    data = np.random.RandomState(0).rand(20, 2)
    ckpt = tmp_path / "som.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt, device="cpu")
    som.random_weights_init(data)
    loaded.random_weights_init(data)
    np.testing.assert_array_equal(som._weights, loaded._weights)


def test_checkpoint_config_roundtrip(tmp_path):
    som = XPySom(3, 7, 2, topology="hexagonal", neighborhood_function="mexican_hat",
                 activation_distance="norm_p", activation_distance_kwargs={"p": 4},
                 compact_support=True, std_coeff=1.2, decay_function="linear",
                 random_seed=1, device="cpu", n_parallel=96, use_kernels=False)
    ckpt = tmp_path / "som.npz"
    som.save_checkpoint(ckpt)
    loaded = XPySom.load_checkpoint(ckpt, device="cpu")
    assert loaded.topology == "hexagonal"
    assert loaded.neighborhood_func_name == "mexican_hat"
    assert loaded._activation_distance_name == "norm_p"
    assert loaded._activation_distance_kwargs == {"p": 4}
    assert loaded.compact_support is True
    assert loaded._std_coeff == 1.2
    assert loaded._decay_function_name == "linear"
    assert loaded._bmu_precision == "highest"
    assert loaded._n_parallel == 96 and loaded._n_parallel_explicit
    assert loaded._use_kernels is False and loaded._use_kernels_explicit


def test_checkpoint_header_is_the_jax_format(tmp_path):
    """An auto-sized model without explicit kernel switches writes
    ``n_parallel`` 0, ``use_pallas`` and ``bmu_tiles`` null, format 1."""
    import json

    som = XPySom(4, 3, 2, random_seed=1, device="cpu")
    som.save_checkpoint(tmp_path / "ck.npz", epoch=2)
    ours = np.load(tmp_path / "ck.npz")
    JaxSom(4, 3, 2, random_seed=1).save_checkpoint(tmp_path / "jax.npz", epoch=2)
    ref = np.load(tmp_path / "jax.npz")
    assert sorted(ours.files) == sorted(ref.files)
    header = json.loads(bytes(ours["header"]).decode())
    ref_header = json.loads(bytes(ref["header"]).decode())
    assert header["format_version"] == 1 and header["epoch"] == 2
    assert header["config"].keys() == ref_header["config"].keys()
    cfg = header["config"]
    assert cfg["n_parallel"] == 0 and cfg["use_pallas"] is None and cfg["bmu_tiles"] is None
    for k in ("weights", "rng_keys", "rng_meta", "rng_gauss"):
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == ref[k].dtype


def test_periodic_checkpointing(tmp_path):
    data = np.random.RandomState(6).rand(128, 3).astype(np.float32)
    ckpt = tmp_path / "periodic.npz"
    full = XPySom(4, 4, 3, random_seed=11, device="cpu").train(data, 6)
    ck = XPySom(4, 4, 3, random_seed=11, device="cpu")
    ck.train(data, 6, checkpoint_path=ckpt, checkpoint_every=2)
    np.testing.assert_array_equal(_bits(ck._weights), _bits(full._weights))
    loaded = XPySom.load_checkpoint(ckpt, device="cpu")
    assert loaded._checkpoint_epoch == 6
    np.testing.assert_array_equal(loaded._weights, ck._weights)
    with pytest.raises(ValueError, match="checkpoint_every"):
        ck.train(data, 6, checkpoint_path=ckpt, checkpoint_every=-1)


def test_checkpoint_extensionless_path(tmp_path):
    som = XPySom(3, 3, 2, random_seed=1, device="cpu")
    p = tmp_path / "ck"
    som.save_checkpoint(p, epoch=1)
    loaded = XPySom.load_checkpoint(p, device="cpu")
    np.testing.assert_array_equal(loaded._weights, som._weights)
    assert loaded._checkpoint_epoch == 1


def test_load_checkpoint_rejects_non_checkpoint_npz(tmp_path):
    p = tmp_path / "not_a_ckpt.npz"
    np.savez(p, foo=np.zeros(3))
    with pytest.raises(ValueError, match="not an xpysom checkpoint"):
        load_checkpoint(p, device="cpu")


def test_load_checkpoint_rejects_newer_format(tmp_path):
    import json

    XPySom(3, 3, 2, random_seed=1, device="cpu").save_checkpoint(tmp_path / "ck.npz")
    with np.load(tmp_path / "ck.npz") as z:
        entries = {k: z[k] for k in z.files}
    header = json.loads(bytes(entries["header"]).decode())
    header["format_version"] = 2
    entries["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(tmp_path / "ck.npz", **entries)
    with pytest.raises(ValueError, match="newer than"):
        load_checkpoint(tmp_path / "ck.npz", device="cpu")


def test_load_checkpoint_rejects_shape_mismatch(tmp_path):
    som = XPySom(4, 3, 2, random_seed=1, device="cpu")
    p = tmp_path / "ckpt.npz"
    som.save_checkpoint(p, epoch=1)
    with np.load(p) as z:
        entries = {k: z[k] for k in z.files}
    entries["weights"] = np.zeros((2, 2, 2), dtype=np.float32)
    np.savez(p, **entries)
    with pytest.raises(ValueError, match="does not match its own config"):
        load_checkpoint(p, device="cpu")


@pytest.mark.parametrize("kernels", [None, False])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, kernels):
    data = np.random.RandomState(4).rand(256, 3).astype(np.float32)
    jax_full = JaxSom(5, 4, 3, sigma=1.5, random_seed=7, use_pallas=kernels).train(data, 6)
    jax_half = JaxSom(5, 4, 3, sigma=1.5, random_seed=7, use_pallas=kernels)
    jax_half.train(data, 6, iter_end=3)
    jax_half.save_checkpoint(tmp_path / "jax.npz", epoch=3)

    ours = XPySom.load_checkpoint(tmp_path / "jax.npz", device="cpu")
    assert ours._checkpoint_epoch == 3
    np.testing.assert_array_equal(ours._weights, np.asarray(jax_half._weights))
    assert ours._use_kernels == (kernels is not False)
    assert ours._use_kernels_explicit == (kernels is not None)
    ours.train(data, 6, iter_beg=ours._checkpoint_epoch)
    np.testing.assert_allclose(ours._weights, np.asarray(jax_full._weights), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernels", [None, False])
def test_port_checkpoint_resumes_in_jax(tmp_path, kernels):
    data = np.random.RandomState(5).rand(256, 3).astype(np.float32)
    kw = dict(sigma=1.5, random_seed=8, device="cpu", use_kernels=kernels)
    full = XPySom(5, 4, 3, **kw).train(data, 6)
    half = XPySom(5, 4, 3, **kw)
    half.train(data, 6, iter_end=3)
    half.save_checkpoint(tmp_path / "port.npz", epoch=3)

    ref = jax_serialization.load_checkpoint(tmp_path / "port.npz")
    assert ref._checkpoint_epoch == 3
    np.testing.assert_array_equal(np.asarray(ref._weights), half._weights)
    assert ref._use_pallas == (kernels is not False)
    assert ref._use_pallas_explicit == (kernels is not None)
    assert not ref._n_parallel_explicit and ref._bmu_tiles is None
    ref.train(data, 6, iter_beg=ref._checkpoint_epoch)
    np.testing.assert_allclose(np.asarray(ref._weights), full._weights, rtol=RTOL, atol=ATOL)


def test_pickle_from_a_card_host_loads_without_a_card(monkeypatch):
    """``device=None`` pickled where a card was available resolves again on
    load: without a card it loads, reads its weights, and its first
    computation raises the constructor's RuntimeError, never running on
    the CPU. An explicit ``device='cpu'`` stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    som = XPySom(4, 4, 3, random_seed=2)
    assert som._device == torch.device("cuda")
    blob = pickle.dumps(som)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loaded = pickle.loads(blob)
    np.testing.assert_array_equal(loaded.get_weights(), som.get_weights())
    assert "device='cuda'" in repr(loaded)
    data = np.random.RandomState(0).rand(16, 3).astype(np.float32)
    for call in (lambda: loaded.train(data, 1), lambda: loaded.quantization_error(data),
                 lambda: loaded.winner(data[0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cpu = pickle.loads(pickle.dumps(XPySom(4, 4, 3, random_seed=2, device="cpu")))
    assert cpu._device == torch.device("cpu")
    np.testing.assert_array_equal(cpu.train(data, 2).get_weights(),
                                  XPySom(4, 4, 3, random_seed=2, device="cpu")
                                  .train(data, 2).get_weights())


def test_pickle_round_trip_via_save_and_load(tmp_path):
    from xpysom_dask_tpu_torch.utils.serialization import load, save

    data = np.random.RandomState(1).rand(64, 3).astype(np.float32)
    som = XPySom(4, 4, 3, random_seed=2, device="cpu").train(data, 2)
    save(som, tmp_path / "som.pkl")
    loaded = load(tmp_path / "som.pkl")
    assert loaded.winner(data[:5]) == som.winner(data[:5])
    np.testing.assert_array_equal(loaded.get_weights(), som.get_weights())


def _bar(text):
    """The bar with its clock fields masked (they differ run to run)."""
    return re.sub(r"\d+:\d\d:\d\d(\.\d+)?", "T", text)


@pytest.mark.parametrize("epochs,n", [(2, 50), (3, 200)])
def test_verbose_prints_the_jax_bar_and_qe(monkeypatch, capsys, epochs, n):
    data = np.random.RandomState(3).rand(n, 3).astype(np.float32)
    bars = {}
    for name, module, som in (
        ("port", port_progress, XPySom(4, 4, 3, random_seed=1, device="cpu")),
        ("jax", jax_progress, JaxSom(4, 4, 3, random_seed=1)),
    ):
        buf = io.StringIO()
        monkeypatch.setattr(module, "stdout", buf)
        som.train(data, epochs, verbose=True)
        bars[name] = (buf.getvalue(), capsys.readouterr().out)
    assert _bar(bars["port"][0]) == _bar(bars["jax"][0])
    assert f"[ {epochs * n} / {epochs * n} ] 100%" in bars["port"][0]
    for name, (_, out) in bars.items():
        assert out.startswith("\n quantization error: "), (name, out)
    qe = [float(out.split(":")[1]) for _, out in bars.values()]
    np.testing.assert_allclose(qe[0], qe[1], rtol=RTOL)


def test_progress_reporter_matches_jax(monkeypatch):
    out = {}
    for name, module in (("port", port_progress), ("jax", jax_progress)):
        buf = io.StringIO()
        monkeypatch.setattr(module, "stdout", buf)
        rep = module.ProgressReporter(40)
        rep.update(-1)
        rep.start()
        for t in (0, 9, 39):
            rep.update(t)
        module.ProgressReporter(0).update(3)
        out[name] = buf.getvalue()
    assert _bar(out["port"]) == _bar(out["jax"])


@pytest.mark.parametrize("topology,x,y,compact", [("rectangular", 6, 5, False),
                                                  ("rectangular", 6, 5, True),
                                                  ("hexagonal", 4, 4, False),
                                                  ("hexagonal", 5, 5, True)])
def test_get_neig_functions_match_jax(topology, x, y, compact):
    kw = dict(sigma=2.0, random_seed=1, topology=topology, compact_support=compact,
              std_coeff=0.7)
    ours = XPySom(x, y, 3, device="cpu", **kw).get_neig_functions()
    ref = JaxSom(x, y, 3, **kw).get_neig_functions()
    assert set(ours) == set(ref)
    assert ("triangle" in ours) == (topology == "rectangular")
    c = (np.array([1, x - 1, 0]), np.array([2, 0, y - 1]))
    for sigma in (2.0, 1.5):
        for name, fn in ours.items():
            got = fn(c, sigma)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            assert got.shape == (3, x, y), name
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[name](c, sigma)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    g = ours["gaussian"](c, 2.0).numpy()
    if topology == "rectangular":
        assert g[0].argmax() == 1 * y + 2 and g[1].argmax() == (x - 1) * y


@pytest.mark.parametrize("kw", [{}, {"use_kernels": False}])
def test_autotune_kernel_on_the_cpu_warns_and_returns_none(kw):
    som = XPySom(4, 4, 3, random_seed=0, device="cpu", **kw)
    with pytest.warns(UserWarning, match="nothing to tune"):
        assert som.autotune_kernel() is None
    with pytest.warns(UserWarning, match="nothing to tune"):
        assert som.autotune_kernel(n_samples=100, candidates=[(8, 128)], inner=2) is None
