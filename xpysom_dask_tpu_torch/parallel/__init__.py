"""Distribution layer of the port: the single-process streaming pipeline
(counterpart of ``xpysom_dask_tpu/parallel/pipeline.py``). Data-parallel
and codebook-sharded training are ROADMAP Queue 1 items 8 and 11."""

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
