"""The resident feed (``models.som._chunks_on`` over
``parallel.pipeline.upload_padded``) on the CPU: the caller's rows copied
straight into the padded chunks on the device, the padding zeroed and the
mask built there. Its chunks, mask and row count are bit for bit what
``core.chunk_data`` followed by ``put_with_sharding`` made (the host's
padded copy, uploaded), for every rank of a data mesh, and it makes no
copy of the input on the host."""

import tracemalloc

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch.core import chunk_data
from xpysom_dask_tpu_torch.models.som import _chunks_on
from xpysom_dask_tpu_torch.parallel.mesh import DataMesh, put_with_sharding

CPU = torch.device("cpu")
D = 5
RANKS = [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1), (3, 2)]  # (world, rank)
ROWS = {"1": lambda c: 1, "7": lambda c: 7, "chunk-1": lambda c: c - 1, "chunk": lambda c: c,
        "chunk+1": lambda c: c + 1, "3*chunk+5": lambda c: 3 * c + 5}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _padded_copy(data, chunk, world, rank):
    """What the API made before: ``chunk_data``'s padded host copy, this
    rank's block of it uploaded (``put_with_sharding``)."""
    mesh = None if world == 1 else DataMesh(None, rank, world, CPU)
    chunks, mask, n = chunk_data(data, chunk, multiple_of=world)
    return put_with_sharding(chunks, mesh, CPU), put_with_sharding(mask, mesh, CPU), n, mesh


def _assert_same(got, want):
    (chunks, mask, n), (w_chunks, w_mask, w_n) = got, want
    assert n == w_n
    assert chunks.shape == w_chunks.shape and mask.shape == w_mask.shape
    assert chunks.dtype == mask.dtype == torch.float32
    assert torch.equal(_bits(chunks), _bits(w_chunks)) and torch.equal(_bits(mask), _bits(w_mask))


@pytest.mark.parametrize("world,rank", RANKS)
@pytest.mark.parametrize("chunk", [8, 1024])
@pytest.mark.parametrize("rows", list(ROWS))
def test_the_feed_is_the_padded_copy_bit_for_bit(rows, chunk, world, rank):
    n = ROWS[rows](chunk)
    data = np.random.RandomState(n + chunk).rand(n, D).astype(np.float32) - 0.5
    data[0, 0] = -0.0  # a negative zero survives the copy
    *want, mesh = _padded_copy(data, chunk, world, rank)
    _assert_same(_chunks_on(data, chunk, mesh, CPU), want)


@pytest.mark.parametrize("kind", ["float64", "fortran order", "column slice", "reversed rows"])
def test_other_layouts_and_dtypes_give_the_chunks_of_today(kind):
    base = np.random.RandomState(3).rand(37, 2 * D)
    data = {
        "float64": base[:, :D],
        "fortran order": np.asfortranarray(base[:, :D].astype(np.float32)),
        "column slice": base.astype(np.float32)[:, ::2],
        "reversed rows": base[::-1, :D].astype(np.float32),
    }[kind]
    for world, rank in RANKS:
        *want, mesh = _padded_copy(data, 8, world, rank)
        _assert_same(_chunks_on(data, 8, mesh, CPU), want)


def test_the_feed_makes_no_host_copy_of_the_input():
    """numpy's allocations are traced by ``tracemalloc`` and torch's tensor
    storage is not: the 16 MiB input leaves the feed's peak under 1 MiB,
    while the padded copy it replaced allocates the whole array again."""
    data = np.random.RandomState(0).rand(1 << 16, 64).astype(np.float32)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        chunks, mask, n = _chunks_on(data, 1024, None, CPU)
        feed_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        chunk_data(data, 1024)
        copy_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert n == 1 << 16 and chunks.shape == (64, 1024, 64) and bool(mask.all())
    assert feed_peak < 1 << 20, feed_peak
    assert copy_peak >= data.nbytes, copy_peak
