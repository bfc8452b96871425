"""Fault: every call leaves out the second half of its rows and takes
the means over the rest."""
from xpysom_dask_tpu_torch.models import som

_chunk_data = som.chunk_data


def _half(data, chunk, multiple_of=1, min_chunks=1):
    return _chunk_data(data[: max(1, data.shape[0] // 2)], chunk, multiple_of, min_chunks)


som.chunk_data = _half
