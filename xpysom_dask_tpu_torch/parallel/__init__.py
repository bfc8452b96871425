"""Distribution layer of the port: data-parallel process groups (counterpart
of ``xpysom_dask_tpu/parallel/mesh.py``) and the streaming pipeline
(``xpysom_dask_tpu/parallel/pipeline.py``). Codebook-sharded training
(``grid_sharded.py``) is ROADMAP Queue 1 item 11."""

from .mesh import (
    DataMesh,
    all_reduce_sum,
    fetch_global,
    initialize_multihost,
    make_data_mesh,
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
    "initialize_multihost",
    "make_data_mesh",
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
