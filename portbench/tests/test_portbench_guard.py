"""The import guard compares top-level names whole."""

import pytest

from harness import guard


@pytest.mark.parametrize("modules,found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["xpysom_dask_tpu", "xpysom_dask_tpu.core"], ["xpysom_dask_tpu"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["xpysom_dask_tpu_torch", "xpysom_dask_tpu_torch.core"], []),
    (["jaxtyping", "numpy", "torch"], []),
])
def test_guard(modules, found):
    assert guard.forbidden_modules(modules) == found


def test_this_process_holds_no_jax():
    import harness.cell  # noqa: F401
    import reference.som  # noqa: F401

    assert guard.forbidden_modules() == []
