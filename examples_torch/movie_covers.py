#!/usr/bin/env python
"""Movie-cover organization (reference examples/MovieCovers.ipynb
workload): arrange ~100 cover images on a 10x10 map by raw-pixel
similarity using the triangle neighborhood, then read back ``win_map``
and ``activation_response``. The notebook's downloaded IMDB covers are
replaced by synthetic 32x20 RGB 'covers' drawn from a few palette/layout
families (no bundled image assets), standardized like the original's
StandardScaler. The PyTorch port's twin of examples/movie_covers.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device

H, W = 32, 20  # cover pixels


def synth_covers(n=100, seed=0):
    """Covers come in 5 'genres': distinct base palette + banding layout,
    plus per-title noise — enough structure for the map to organize."""
    rng = np.random.RandomState(seed)
    palettes = rng.rand(5, 3, 3)  # genre x (top, middle, bottom) x RGB
    covers = []
    genres = []
    yy = np.linspace(0, 2, H)[:, None, None]  # vertical band coordinate
    for i in range(n):
        g = i % 5
        top, mid, bot = palettes[g]
        img = (
            np.clip(1 - yy, 0, 1) * top
            + np.clip(1 - np.abs(yy - 1), 0, 1) * mid
            + np.clip(yy - 1, 0, 1) * bot
        )
        img = np.broadcast_to(img, (H, W, 3)) + 0.08 * rng.randn(H, W, 3)
        covers.append(img.astype(np.float32).ravel())
        genres.append(g)
    return np.stack(covers), np.array(genres)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    data, genres = synth_covers()
    mean, std = data.mean(axis=0), data.std(axis=0) + 1e-9
    data = (data - mean) / std

    som = XPySom(
        10,
        10,
        data.shape[1],
        learning_rate=0.5,
        sigma=3,
        neighborhood_function="triangle",
        random_seed=2,
        device=device,
    )
    som.train(data, 60, verbose=True)

    win_map = som.win_map(data)
    act = som.activation_response(data)
    print(f"\noccupied cells: {len(win_map)}/100, busiest holds {int(act.max())}")

    # genre purity per cell: triangle-neighborhood pixel SOM should mostly
    # keep palette families together
    flat = som.predict(data)
    purity = []
    for cell in np.unique(flat):
        members = genres[flat == cell]
        purity.append((members == np.bincount(members).argmax()).mean())
    print(f"mean per-cell genre purity: {float(np.mean(purity)):.2f}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        fig, axes = plt.subplots(10, 10, figsize=(10, 14))
        for (px, py), imgs in win_map.items():
            img = imgs[0] * std + mean
            axes[px][py].imshow(np.clip(img.reshape(H, W, 3), 0, 1))
        for ax in axes.ravel():
            ax.axis("off")
        fig.savefig(os.path.join(out, "movie_covers_grid.png"), dpi=80)
        print(f"wrote {out}/movie_covers_grid.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
