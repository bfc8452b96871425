#!/usr/bin/env python
"""Hexagonal topology (reference examples/HexagonalTopology.ipynb
workload): hex grid training, euclidean coordinates, U-matrix. The
PyTorch port's twin of examples/hexagonal_topology.py (needs
scikit-learn for the data set)."""

import argparse
import os
import sys

import numpy as np
from sklearn import datasets

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    iris = datasets.load_iris()
    data = iris.data.astype(np.float32)
    data = (data - data.mean(0)) / data.std(0)

    som = XPySom(10, 10, 4, sigma=2, topology="hexagonal", random_seed=1, device=device)
    som.train(data, 50)

    print("quantization error:", round(som.quantization_error(data), 4))
    print("topographic error: ", round(som.topographic_error(data), 4))

    xx, yy = som.get_euclidean_coordinates()
    print("hex offset rows (xx[:, 0..3]):")
    print(np.round(xx[:4, :4], 2))
    cx, cy = som.convert_map_to_euclidean((2, 3))
    print("map cell (2,3) sits at euclidean", (float(cx), float(cy)))

    um = som.distance_map()
    print("U-matrix range:", round(float(um.min()), 3), "-", round(float(um.max()), 3))


if __name__ == "__main__":
    main()
