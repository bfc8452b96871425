#!/usr/bin/env python
"""Clustering with a SOM (reference examples/Clustering.ipynb workload):
winner coordinates as cluster assignments on 2-D gaussian blobs. The
PyTorch port's twin of examples/clustering.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    rng = np.random.RandomState(0)
    centers = np.array([[0, 0], [4, 4], [0, 5], [5, 0]], dtype=np.float32)
    data = np.concatenate(
        [c + 0.4 * rng.randn(250, 2).astype(np.float32) for c in centers]
    )

    som = XPySom(2, 2, 2, sigma=1.0, random_seed=1, device=device)
    som.train(data, 30)

    flat = som.predict(data)
    print("cluster sizes:", np.bincount(flat.astype(int), minlength=4).tolist())
    # purity vs. the generating blobs
    truth = np.repeat(np.arange(4), 250)
    purity = 0
    for k in range(4):
        members = truth[flat == k]
        if len(members):
            purity += np.bincount(members).max()
    print(f"purity: {purity / len(data):.3f}")
    print("codebook (cluster centers):")
    print(np.round(som.get_weights().reshape(-1, 2), 2))


if __name__ == "__main__":
    main()
