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
    "FED",
    "FEEDS",
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


# the searches that count their launches by feed (``bmu.search_feed``):
# each wrapper's ``paired`` counts those that ran as pairs of row blocks
# sharing each codebook chunk, ``registers`` those that held A in registers,
# ``wide`` those that searched tiles of 256 codebook rows (``bmu.search_tile``),
# ``streamed`` those that streamed A beside each codebook chunk, one block a
# row block
FED = ("bmu_argmin", "bmu_top2")
FEEDS = ("paired", "registers", "wide", "streamed")


def launch_counts() -> dict:
    """Each kernel's launches by name, and ``<name>.paired``,
    ``<name>.registers``, ``<name>.wide`` and ``<name>.streamed`` for each
    search of ``FED``: how many of its launches ran on those feeds, and on
    256-wide tiles."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts.update({f"{name}.{feed}": getattr(KERNELS[name], feed) for name in FED
                   for feed in FEEDS})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in FED:
        for feed in FEEDS:
            setattr(KERNELS[name], feed, 0)
