"""Hand-written Hopper kernels of the port (counterpart of
``xpysom_dask_tpu/ops/pallas``), each behind a wrapper that counts its
launches, plus the wrappers' plain PyTorch versions."""

from .bmu import PackedCodebook, bmu_argmin, bmu_top2
from .stats import scatter_stats

__all__ = [
    "bmu_argmin",
    "bmu_top2",
    "PackedCodebook",
    "scatter_stats",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

# name -> wrapper; each wrapper's ``launches`` counts its kernel launches
KERNELS = {
    "bmu_argmin": bmu_argmin,
    "bmu_top2": bmu_top2,
    "scatter_stats": scatter_stats,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
