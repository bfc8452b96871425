#!/usr/bin/env python
"""Democracy-index mapping (reference examples/DemocracyIndex.ipynb
workload): place countries on a 15x15 hexagonal-convention map by their
six EIU democracy sub-scores, PCA-initialized, then chart the U-matrix
with country labels and the six component planes. The PyTorch port's twin
of examples/democracy_index.py; it reads examples/democracy_index.csv in
place."""

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "..", "examples", "democracy_index.csv")
FEATURES = [
    "democracy_index",
    "electoral_processand_pluralism",
    "functioning_of_government",
    "political_participation",
    "political_culture",
    "civil_liberties",
]
CATEGORY_COLOR = {
    "Full democracy": "darkgreen",
    "Flawed democracy": "limegreen",
    "Hybrid regime": "darkorange",
    "Authoritarian": "crimson",
}


def load():
    with open(DATA) as f:
        rows = list(csv.DictReader(f))
    X = np.array([[float(r[k]) for k in FEATURES] for r in rows], np.float32)
    countries = [r["country"] for r in rows]
    categories = [r["category"] for r in rows]
    return X, countries, categories


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    X, countries, categories = load()
    # column-standardize (the notebook's sklearn.preprocessing.scale)
    X = (X - X.mean(axis=0)) / X.std(axis=0)

    size = 15
    som = XPySom(size, size, X.shape[1], sigma=1.5, random_seed=1, device=device)
    som.pca_weights_init(X)
    som.train(X, 120, verbose=True)

    country_map = som.labels_map(X, countries)
    print(f"\nQE {som.quantization_error(X):.3f}  TE {som.topographic_error(X):.3f}")
    # a few sanity reads: cells mixing regime categories are rare
    cat_of = dict(zip(countries, categories))
    mixed = sum(
        1
        for cell, labels in country_map.items()
        if len({cat_of[c] for c in labels}) > 2
    )
    print(f"{len(country_map)} occupied cells, {mixed} mixing >2 regime types")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Patch

        out = os.path.join(HERE, "out")
        os.makedirs(out, exist_ok=True)

        plt.figure(figsize=(14, 14))
        for (px, py), labels in country_map.items():
            for i, c in enumerate(labels):
                off = (i + 1) / len(labels) - 0.05
                plt.text(
                    px + 0.1,
                    py - 0.3 + off,
                    c[:6],
                    color=CATEGORY_COLOR[cat_of[c]],
                    fontsize=9,
                )
        plt.pcolor(som.distance_map().T, cmap="gray_r", alpha=0.2)
        plt.xticks(np.arange(size + 1))
        plt.yticks(np.arange(size + 1))
        plt.grid()
        plt.legend(
            handles=[
                Patch(facecolor=clr, edgecolor="w", label=lbl)
                for lbl, clr in CATEGORY_COLOR.items()
            ],
            loc="upper right",
        )
        plt.savefig(os.path.join(out, "democracy_index_map.png"), dpi=100)

        W = som.get_weights()
        plt.figure(figsize=(10, 10))
        for i, f in enumerate(FEATURES):
            plt.subplot(3, 3, i + 1)
            plt.title(f, fontsize=8)
            plt.pcolor(W[:, :, i].T, cmap="coolwarm")
        plt.tight_layout()
        plt.savefig(os.path.join(out, "democracy_index_planes.png"), dpi=100)
        print(f"wrote {out}/democracy_index_map.png and _planes.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
