#!/usr/bin/env python
"""Time-series motif discovery (reference examples/TimeSeries.ipynb
workload): sliding windows mapped onto an 8x8 SOM; win_map groups similar
windows. The PyTorch port's twin of examples/time_series.py."""

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

    t = np.linspace(0, 40 * np.pi, 4000)
    series = np.sin(t) + 0.3 * np.sin(3.1 * t) + 0.05 * np.random.RandomState(0).randn(len(t))

    win = 32
    windows = np.lib.stride_tricks.sliding_window_view(series, win)[::8].astype(
        np.float32
    )
    print(f"{windows.shape[0]} windows of length {win}")

    som = XPySom(8, 8, win, sigma=3, random_seed=2, device=device)
    som.train(windows, 20)

    wm = som.win_map(windows)
    sizes = sorted(((len(v), k) for k, v in wm.items()), reverse=True)[:5]
    print("largest motif cells:")
    for n, cell in sizes:
        print(f"  cell {cell}: {n} windows")
    print("quantization error:", round(som.quantization_error(windows), 4))


if __name__ == "__main__":
    main()
