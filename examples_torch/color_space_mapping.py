#!/usr/bin/env python
"""Color space mapping (reference examples/ColorSpaceMapping.ipynb
workload): organize 15 named RGB colors on a 30x30 map so similar colors
become neighbors — the classic Kohonen demo. Trains the notebook's two
configurations (gaussian sigma=3 / bubble sigma=8) and writes the learned
color sheets. The PyTorch port's twin of examples/color_space_mapping.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device

COLORS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, 0.5],
        [0.125, 0.529, 1.0],
        [0.33, 0.4, 0.67],
        [0.6, 0.5, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 1.0],
        [1.0, 0.0, 1.0],
        [1.0, 1.0, 0.0],
        [1.0, 1.0, 1.0],
        [0.33, 0.33, 0.33],
        [0.5, 0.5, 0.5],
        [0.66, 0.66, 0.66],
    ],
    dtype=np.float32,
)
COLOR_NAMES = [
    "black", "blue", "darkblue", "skyblue", "greyblue", "lilac", "green",
    "red", "cyan", "violet", "yellow", "white", "darkgrey", "mediumgrey",
    "lightgrey",
]


def train_config(name, device, **kwargs):
    som = XPySom(30, 30, 3, random_seed=1, device=device, **kwargs)
    som.train(COLORS, 100)
    qe = som.quantization_error(COLORS)
    print(f"{name}: QE {qe:.4f}")
    for color, cname in zip(COLORS, COLOR_NAMES):
        print(f"  {cname:11s} -> node {som.winner(color)}")
    return som


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    som_g = train_config(
        "gaussian sigma=3 lr=2.5",
        device,
        sigma=3.0,
        learning_rate=2.5,
        neighborhood_function="gaussian",
    )
    som_b = train_config(
        "bubble sigma=8 lr=0.5",
        device,
        sigma=8.0,
        learning_rate=0.5,
        neighborhood_function="bubble",
    )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        fig, ax = plt.subplots(1, 2, figsize=(10, 5))
        ax[0].imshow(np.abs(som_g.get_weights()), interpolation="none")
        ax[0].set_title("gaussian σ=3")
        ax[1].imshow(np.abs(som_b.get_weights()), interpolation="none")
        ax[1].set_title("bubble σ=8")
        for a in ax:
            a.set_xticks([])
            a.set_yticks([])
        fig.savefig(os.path.join(out, "color_space_mapping.png"), dpi=100)
        print(f"wrote {out}/color_space_mapping.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
