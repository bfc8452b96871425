"""Hand-written Hopper kernels of the port (counterpart of
``xpysom_dask_tpu/ops/pallas``), each behind a wrapper that counts its
launches, plus the wrappers' plain PyTorch versions."""

from .bmu import PackedCodebook, bmu_argmin, bmu_argmin_kb, bmu_highest, bmu_split3, bmu_top2
from .elementwise import ElementwiseCodebook, bmu_manhattan, bmu_norm_p_frac, bmu_norm_p_odd
from .fused_stats import bmu_stats_fused
from .manhattan import manhattan_distance
from .stats import scatter_stats

__all__ = [
    "bmu_argmin",
    "bmu_argmin_kb",
    "bmu_top2",
    "bmu_split3",
    "bmu_highest",
    "bmu_manhattan",
    "bmu_norm_p_odd",
    "bmu_norm_p_frac",
    "manhattan_distance",
    "PackedCodebook",
    "ElementwiseCodebook",
    "scatter_stats",
    "bmu_stats_fused",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
]

# name -> wrapper; each wrapper's ``launches`` counts its kernel launches
KERNELS = {
    "bmu_argmin": bmu_argmin,
    "bmu_top2": bmu_top2,
    "scatter_stats": scatter_stats,
    "bmu_highest": bmu_highest,
    "bmu_manhattan": bmu_manhattan,
    "bmu_norm_p_odd": bmu_norm_p_odd,
    "bmu_norm_p_frac": bmu_norm_p_frac,
    "bmu_split3": bmu_split3,
    "manhattan_distance": manhattan_distance,
    "bmu_argmin_kb": bmu_argmin_kb,
    "bmu_stats_fused": bmu_stats_fused,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
