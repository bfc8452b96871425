"""Fault: the search alters one answer where it is produced: the first
row of every chunk gets the unit half the map away from its winner."""
from xpysom_dask_tpu_torch import core

_bmu_chunk = core._bmu_chunk


def _altered(spec, search, x):
    idx = _bmu_chunk(spec, search, x).clone()
    idx[0] = (idx[0] + spec.xy // 2) % spec.xy
    return idx


core._bmu_chunk = _altered
