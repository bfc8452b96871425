"""Distribution layer of the port: data-parallel process groups and (data,
model) grids (counterpart of ``xpysom_dask_tpu/parallel/mesh.py``),
codebook-sharded training and scoring (``grid_sharded.py``) and the
streaming pipeline (``xpysom_dask_tpu/parallel/pipeline.py``)."""

from .mesh import (
    DataMesh,
    GridMesh,
    all_reduce_sum,
    fetch_global,
    initialize_multihost,
    make_data_mesh,
    make_grid_mesh,
    mesh_spans_processes,
    put_with_sharding,
    resolve_mesh,
)
from .pipeline import (
    ArraySource,
    DataSource,
    FileSource,
    IterableSource,
    ShardedFileSource,
    default_superbatch_rows,
    device_superbatches,
    stats_streaming,
    train_streaming,
)

__all__ = [
    "DataMesh",
    "GridMesh",
    "initialize_multihost",
    "make_data_mesh",
    "make_grid_mesh",
    "resolve_mesh",
    "mesh_spans_processes",
    "put_with_sharding",
    "fetch_global",
    "all_reduce_sum",
    "DataSource",
    "ArraySource",
    "FileSource",
    "IterableSource",
    "ShardedFileSource",
    "default_superbatch_rows",
    "device_superbatches",
    "stats_streaming",
    "train_streaming",
]
