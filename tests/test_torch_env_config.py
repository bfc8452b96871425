"""The PyTorch port reads the env switches as the JAX package does: once,
at construction (``SomSpec.__post_init__``), with explicit arguments
winning, junk warning and falling back, and norm_p keeping ``'highest'``.
Twins of ``tests/test_bmu_config.py``'s env tests; the warning texts are
held against the JAX package's own."""

import warnings

import pytest

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.core import SomSpec

_NORM_P4 = dict(activation_distance="norm_p", activation_distance_kwargs={"p": 4})


def _warning_texts(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught if "XPYSOM_BMU_PRECISION" in str(w.message)]


def test_env_read_once_at_construction(monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_BMU_TILES", "512x1024")  # TPU-only: ignored
    monkeypatch.setenv("XPYSOM_TPU_NO_PALLAS", "1")
    som = XPySom(4, 4, 8, device="cpu")
    monkeypatch.delenv("XPYSOM_BMU_PRECISION")
    monkeypatch.delenv("XPYSOM_BMU_TILES")
    monkeypatch.delenv("XPYSOM_TPU_NO_PALLAS")
    # resolved values survive env removal
    assert som._bmu_precision == "bf16"
    assert som._use_kernels is False
    assert som._spec.bmu_precision == "bf16" and som._spec.use_kernels is False
    # a freshly built SOM goes back to the defaults
    fresh = XPySom(4, 4, 8, device="cpu")
    assert fresh._bmu_precision == "packed"
    assert fresh._use_kernels is True
    # 'FLAG=0' means off
    monkeypatch.setenv("XPYSOM_TPU_NO_PALLAS", "0")
    assert XPySom(4, 4, 8, device="cpu")._use_kernels is True


def test_explicit_kwargs_beat_env(monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "bf16")
    monkeypatch.setenv("XPYSOM_TPU_NO_PALLAS", "1")
    som = XPySom(4, 4, 8, device="cpu", bmu_precision="split3", use_kernels=True)
    assert som._bmu_precision == "split3"
    assert som._use_kernels is True
    # an omitted argument still takes the env, beside an explicit one
    assert XPySom(4, 4, 8, device="cpu", use_kernels=True)._bmu_precision == "bf16"
    assert XPySom(4, 4, 8, device="cpu", bmu_precision="packed")._use_kernels is False
    # the spec: explicit fields win, omitted ones read the env
    assert SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01, bmu_precision="highest").bmu_precision == \
        "highest"
    assert SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01).bmu_precision == "bf16"
    # an explicit mode under norm_p is the caller's choice: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert XPySom(4, 4, 8, device="cpu", bmu_precision="bf16",
                      **_NORM_P4)._bmu_precision == "bf16"


def test_env_junk_warns_at_construction(monkeypatch):
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", "float16")
    with pytest.warns(UserWarning, match="XPYSOM_BMU_PRECISION"):
        som = XPySom(4, 4, 8, device="cpu")
    assert som._bmu_precision == "packed"
    with pytest.warns(UserWarning, match="XPYSOM_BMU_PRECISION"):
        spec = SomSpec(4, 4, 8, 2.0, 1.0, 0.5, 0.01)
    assert spec.bmu_precision == "packed"
    # explicit junk still raises
    with pytest.raises(ValueError, match="not recognized"):
        XPySom(4, 4, 8, device="cpu", bmu_precision="float16")


@pytest.mark.parametrize("env,kw", [("float16", {}), ("bf16", _NORM_P4), ("margin", _NORM_P4)])
def test_env_warnings_and_modes_match_jax(monkeypatch, env, kw):
    """The same env value gives the same resolved mode and the same
    warning text in both packages (norm_p keeps 'highest')."""
    monkeypatch.setenv("XPYSOM_BMU_PRECISION", env)
    got = _warning_texts(lambda: XPySom(4, 4, 8, device="cpu", **kw))
    want = _warning_texts(lambda: JaxSom(4, 4, 8, **kw))
    assert got == want and len(got) == 1
    assert XPySom(4, 4, 8, device="cpu", **kw)._bmu_precision == \
        JaxSom(4, 4, 8, **kw)._bmu_precision
