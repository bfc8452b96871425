#!/usr/bin/env python
"""Outlier detection by quantization-error thresholding (reference
examples/OutliersDetection.ipynb workload). The PyTorch port's twin of
examples/outliers_detection.py."""

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
    inliers = rng.randn(950, 2).astype(np.float32)
    outliers = rng.uniform(-8, 8, size=(50, 2)).astype(np.float32)
    outliers = outliers[np.linalg.norm(outliers, axis=1) > 4]
    data = np.concatenate([inliers, outliers])
    truth = np.concatenate([np.zeros(len(inliers)), np.ones(len(outliers))])

    som = XPySom(5, 5, 2, sigma=2, random_seed=7, device=device)
    som.train(inliers, 30)  # train on clean data only

    # per-sample quantization error = distance to own BMU code vector
    q = som.quantization(data)
    err = np.linalg.norm(data - q, axis=1)
    thresh = np.percentile(err[: len(inliers)], 99)
    flagged = err > thresh

    tp = int(np.sum(flagged & (truth == 1)))
    fp = int(np.sum(flagged & (truth == 0)))
    print(f"threshold={thresh:.3f}: flagged {flagged.sum()} "
          f"({tp}/{len(outliers)} true outliers, {fp} false positives)")


if __name__ == "__main__":
    main()
