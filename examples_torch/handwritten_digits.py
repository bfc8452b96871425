#!/usr/bin/env python
"""Handwritten digits (reference examples/HandwrittenDigits.ipynb
workload): 1797x64 digits onto a 30x30 SOM with exponential decay. The
PyTorch port's twin of examples/handwritten_digits.py (needs
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

    digits = datasets.load_digits()
    data = (digits.data / 16.0).astype(np.float32)
    labels = digits.target

    som = XPySom(30, 30, 64, sigma=8, decay_function="exponential", random_seed=5,
                 device=device)
    som.train(data, 20)

    print("quantization error:", round(som.quantization_error(data), 4))
    print("topographic error: ", round(som.topographic_error(data), 4))

    resp = som.activation_response(data)
    print(f"occupied cells: {int((resp > 0).sum())}/900, "
          f"max hits in one cell: {int(resp.max())}")

    lm = som.labels_map(data, labels)
    pure = sum(1 for c in lm.values() if len(c) == 1)
    print(f"label-pure cells: {pure}/{len(lm)}")


if __name__ == "__main__":
    main()
