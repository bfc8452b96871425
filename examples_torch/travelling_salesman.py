#!/usr/bin/env python
"""Travelling-salesman heuristic with a 1xN ring SOM (reference
examples/TravellingSalesmanProblem.ipynb workload — the 1-D grid case).
The PyTorch port's twin of examples/travelling_salesman.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device


def tour_length(cities, order):
    path = cities[order]
    return float(
        np.sum(np.linalg.norm(np.roll(path, -1, axis=0) - path, axis=1))
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    rng = np.random.RandomState(4)
    n_cities = 20
    cities = rng.rand(n_cities, 2).astype(np.float32)

    som = XPySom(1, 8 * n_cities, 2, sigma=n_cities, sigmaN=1,
                 learning_rate=0.5, random_seed=1, device=device)
    som.random_weights_init(cities)
    som.train(cities, 60)

    # visit cities in ring order of their BMU
    flat = som.predict(cities)
    order = np.argsort(flat)
    base = tour_length(cities, np.arange(n_cities))
    opt = tour_length(cities, order)
    print(f"random-order tour: {base:.3f}")
    print(f"ring-SOM tour:     {opt:.3f}  ({100 * (1 - opt / base):.0f}% shorter)")


if __name__ == "__main__":
    main()
