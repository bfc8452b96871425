#!/usr/bin/env python
"""Iris dimensionality reduction (reference examples/Iris.ipynb workload):
7x7 SOM over the 150x4 Iris data; per-cell label majorities, quality
metrics, U-matrix. The PyTorch port's twin of examples/iris.py (needs
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
    labels = np.asarray(iris.target_names)[iris.target]

    som = XPySom(7, 7, 4, sigma=3, learning_rate=0.5, random_seed=10, device=device)
    som.pca_weights_init(data)
    som.train(data, 50)

    print("quantization error:", round(som.quantization_error(data), 4))
    print("topographic error: ", round(som.topographic_error(data), 4))

    lm = som.labels_map(data, labels)
    grid = np.full((7, 7), "", dtype=object)
    for (i, j), counter in lm.items():
        grid[i, j] = counter.most_common(1)[0][0][:4]
    print("label majority per cell:")
    for row in grid:
        print("  " + " ".join(f"{c or '.':>4}" for c in row))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        plt.figure(figsize=(5, 5))
        plt.pcolor(som.distance_map().T, cmap="bone_r")
        plt.colorbar()
        plt.title("Iris U-matrix")
        plt.savefig(os.path.join(out, "iris_umatrix.png"), dpi=100)
        print("wrote", os.path.join(out, "iris_umatrix.png"))
    except ImportError:
        pass


if __name__ == "__main__":
    main()
