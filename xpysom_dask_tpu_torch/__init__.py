"""PyTorch/CUDA port of xpysom_dask_tpu: batch Self-Organizing Maps with
hand-written Hopper kernels for the BMU search and the statistics
scatter. Imports torch and numpy only."""

from .models.population import SomPopulation
from .models.som import XPySom

__all__ = ["XPySom", "SomPopulation"]
__version__ = "0.1.0"
