#!/usr/bin/env python
"""Poem-embedding map (reference examples/PoemsAnalysis.ipynb workload):
place poems by three authors on a 16x16 map of their mean word-embedding
vectors and check that authorship clusters spatially. The notebook's
scraped poemhunter.com texts + GloVe vectors are replaced by synthetic
50-d 'mean embedding' vectors drawn per-author (each author = a distinct
direction mixture), exercising ``random_weights_init`` on text-style
dense vectors exactly as the original. The PyTorch port's twin of
examples/poems_analysis.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device

AUTHORS = ["neruda", "bukowski", "poe"]
DIM = 50  # glove.6B.50d in the notebook


def synth_poem_vectors(per_author=60, seed=4):
    """Each author mixes 3 latent 'themes'; a poem is a noisy convex
    mixture — mimicking means of GloVe vectors over a poem's words."""
    rng = np.random.RandomState(seed)
    vecs, labels = [], []
    for a in range(len(AUTHORS)):
        themes = rng.randn(3, DIM) * 0.8 + rng.randn(1, DIM) * 0.4
        for _ in range(per_author):
            mix = rng.dirichlet([1.0, 1.0, 1.0])
            vecs.append(mix @ themes + 0.15 * rng.randn(DIM))
            labels.append(a)
    return np.asarray(vecs, np.float32), np.asarray(labels)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    W, y = synth_poem_vectors()

    map_dim = 16
    som = XPySom(map_dim, map_dim, DIM, sigma=1.0, random_seed=1, device=device)
    som.random_weights_init(W)
    som.train_batch(W, 500, verbose=True)

    # authorship locality: how often a poem's nearest neighbor on the map
    # (same winner cell) shares its author
    flat = som.predict(W)
    same = 0
    pairs = 0
    for cell in np.unique(flat):
        members = y[flat == cell]
        if len(members) > 1:
            maj = np.bincount(members).argmax()
            same += (members == maj).sum()
            pairs += len(members)
    print(
        f"\nQE {som.quantization_error(W):.3f}; "
        f"co-located poems sharing the majority author: {same}/{pairs}"
    )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        colors = ["chocolate", "steelblue", "dimgray"]
        plt.figure(figsize=(12, 12))
        rng = np.random.RandomState(0)
        for i, (wx, wy) in enumerate(som.winner(W)):
            plt.text(
                wx,
                wy + rng.rand() * 0.9,
                f"{AUTHORS[y[i]]}-{i % 60}",
                color=colors[y[i]],
                fontsize=7,
            )
        plt.xticks(range(map_dim))
        plt.yticks(range(map_dim))
        plt.grid()
        plt.xlim([0, map_dim])
        plt.ylim([0, map_dim])
        plt.savefig(os.path.join(out, "poems_map.png"), dpi=100)
        print(f"wrote {out}/poems_map.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
