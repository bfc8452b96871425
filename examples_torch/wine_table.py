#!/usr/bin/env python
"""Tabular analysis with labels (the reference's DemocracyIndex.ipynb
workload shape: a feature table + per-row labels → distance_map with label
overlay): sklearn wine dataset, 13 features, 3 cultivars. The PyTorch
port's twin of examples/wine_table.py (needs scikit-learn for the data
set)."""

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

    wine = datasets.load_wine()
    data = wine.data.astype(np.float32)
    data = (data - data.mean(0)) / data.std(0)
    labels = np.asarray(wine.target_names)[wine.target]

    som = XPySom(9, 9, data.shape[1], sigma=3, random_seed=4, device=device)
    som.pca_weights_init(data)
    som.train(data, 60)

    print("quantization error:", round(som.quantization_error(data), 4))
    print("topographic error: ", round(som.topographic_error(data), 4))

    lm = som.labels_map(data, labels)
    grid = np.full((9, 9), ".", dtype=object)
    for (i, j), counter in lm.items():
        grid[i, j] = counter.most_common(1)[0][0][:7]
    print("cultivar majority per cell:")
    for row in grid:
        print("  " + " ".join(f"{c:>8}" for c in row))
    pure = sum(1 for c in lm.values() if len(c) == 1)
    print(f"{pure}/{len(lm)} occupied cells are single-cultivar")

    um = som.distance_map()
    print("U-matrix ridge (max) at:", np.unravel_index(um.argmax(), um.shape))


if __name__ == "__main__":
    main()
