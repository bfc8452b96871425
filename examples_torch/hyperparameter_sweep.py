#!/usr/bin/env python
"""Hyperparameter sweep with SomPopulation: P maps behind one API. The
PyTorch port's twin of examples/hyperparameter_sweep.py.

The classic SOM model-selection loop — train several maps with different
seeds and σ schedules, keep the lowest-QE one — runs serially in the
reference (one full train per candidate). ``SomPopulation`` runs the
whole sweep through one call: with the default ``strategy='auto'``,
resident data runs ``'serial'`` (each member's epoch over one shared
device-resident copy of the data). ``strategy='batched'`` (one
concatenated fp32 GEMM a chunk) and ``'fused'`` (every member in one
pass over a stream, the streaming default) are available explicitly —
see docs/torch/API.md.

Headless: prints the per-member QE table and the winning configuration.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import SomPopulation
from xpysom_dask_tpu_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    # three well-separated gaussian blobs (the clustering example's data shape)
    rng = np.random.RandomState(0)
    centers = rng.rand(3, 16) * 4
    data = np.concatenate(
        [c + 0.15 * rng.randn(400, 16) for c in centers]
    ).astype(np.float32)

    # sweep: 4 sigmas x 2 seeds = 8 members, every other knob shared
    sigmas = [0.8, 1.5, 2.5, 4.0] * 2
    seeds = [10] * 4 + [20] * 4

    pop = SomPopulation(
        8,
        12,
        12,
        16,
        sigma=sigmas,
        random_seed=seeds,
        learning_rate=0.5,
        device=device,
    )
    pop.train(data, 8)

    qes = pop.quantization_errors(data)
    print("member  sigma  seed   QE")
    for i, (s, sd, q) in enumerate(zip(sigmas, seeds, qes)):
        print(f"{i:6d}  {s:5.1f}  {sd:4d}   {q:.4f}")

    best = pop.best(data)
    i_best = int(np.argmin(qes))
    print(
        f"\nbest: member {i_best} (sigma={sigmas[i_best]}, seed={seeds[i_best]}) "
        f"QE={qes[i_best]:.4f}"
    )
    # the winner is a normal XPySom: full inference/analysis API
    print("distance_map shape:", best.distance_map().shape)
    # best(data) must agree with the QE table it is defined by
    if best is not pop.member(i_best):
        raise RuntimeError("best(data) is not the member of lowest QE")


if __name__ == "__main__":
    main()
