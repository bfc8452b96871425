"""The import guard: no run may load JAX or the JAX package. Modules are
compared by their top-level name (the part before the first dot), whole:
``xpysom_dask_tpu_torch`` begins with the JAX package's name but is not
it."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "xpysom_dask_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    names in ``sys.modules``), sorted."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))
