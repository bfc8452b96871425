#!/usr/bin/env python
"""SOM inside an sklearn pipeline (no reference-notebook counterpart —
the adapter is an extra this build ships): standardize → train SOM →
cluster, evaluate against ground-truth blobs, and pick the map size by
quantization-error model selection. The PyTorch port's twin of
examples/sklearn_pipeline.py (needs scikit-learn)."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from sklearn.datasets import make_blobs
from sklearn.metrics import homogeneity_score
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler

from xpysom_dask_tpu_torch.sklearn import SomClusterer
from xpysom_dask_tpu_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    X, y = make_blobs(
        n_samples=1500, centers=5, n_features=8, cluster_std=1.2, random_state=7
    )
    X = X.astype(np.float32)

    pipe = make_pipeline(
        StandardScaler(),
        SomClusterer(8, 8, num_epochs=20, sigma=2.5, random_seed=3, device=device),
    )
    node = pipe.fit_predict(X)
    som = pipe[-1]
    print(f"8x8 map: QE={som.quantization_error_:.4f}, "
          f"{np.unique(node).size} occupied nodes")

    # BMU nodes are a fine (64-way) clustering of the 5 blobs; homogeneity
    # measures that each occupied node holds samples of a single blob
    print(f"homogeneity (node labels vs blobs): "
          f"{homogeneity_score(y, node):.3f}")

    # model selection over map size via the sklearn score contract (-QE)
    Xs = StandardScaler().fit_transform(X).astype(np.float32)
    for xy in (4, 6, 10):
        est = SomClusterer(xy, xy, num_epochs=20, sigma=2.5, random_seed=3, device=device)
        est.fit(Xs)
        print(f"{xy}x{xy}: score={est.score(Xs):.4f}")

    # vector quantization: reconstruct samples from their BMU codebook row
    recon = som.inverse_transform(node)
    mse = float(np.mean((Xs - recon) ** 2))
    print(f"vector-quantization MSE at 8x8: {mse:.4f}")


if __name__ == "__main__":
    main()
