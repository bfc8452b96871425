#!/usr/bin/env python
"""Large-scale streamed training (the seismic-scale workload: huge-N data
that doesn't fit on the device). The PyTorch port's twin of
examples/large_scale_streaming.py.

Demonstrates the replacements for the reference's Dask layer:
- FileSource: the native C++ double-buffered reader over a binary
  dataset, fed to the card through pinned buffers
- mesh='auto': data parallel over the processes of the default
  torch.distributed group (one process, a world of one, without one)
- a portable checkpoint (the .npz format either package reads)

Defaults are sized to finish in seconds; crank N for a real run
(the north star is N=10^8, D=64, 128x128 codebook).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.parallel import FileSource
from xpysom_dask_tpu_torch.utils import resolve_device
from xpysom_dask_tpu_torch.utils.native import native_available


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("-d", type=int, default=16)
    ap.add_argument("-x", type=int, default=32)
    ap.add_argument("-y", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--mesh", default=None, help="'auto', an int, or omit")
    ap.add_argument("--file", default="/tmp/xsom_demo_torch.f32",
                    help="the binary dataset (written if absent); the checkpoint "
                         "goes beside it as <file stem>_ckpt.npz")
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device={device}")

    if not os.path.exists(args.file) or os.path.getsize(args.file) != args.n * args.d * 4:
        print(f"generating {args.n * args.d * 4 / 1e6:.0f} MB dataset at {args.file}")
        rng = np.random.RandomState(0)
        with open(args.file, "wb") as f:
            block = 1 << 20
            for start in range(0, args.n, block):
                rows = min(block, args.n - start)
                f.write(rng.rand(rows, args.d).astype(np.float32).tobytes())

    mesh = args.mesh
    if isinstance(mesh, str) and mesh.isdigit():
        mesh = int(mesh)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"device={device} cards={cards} native_loader={native_available()} mesh={mesh}")

    som = XPySom(args.x, args.y, args.d, random_seed=1, mesh=mesh, device=device)
    src = FileSource(args.file, args.n, args.d)
    t0 = time.time()
    som.train(src, args.epochs)
    dt = time.time() - t0
    print(f"{args.epochs} epochs x {args.n:,} rows in {dt:.1f}s "
          f"-> {args.epochs * args.n / dt:,.0f} samples/s")

    ckpt = os.path.splitext(args.file)[0] + "_ckpt.npz"
    som.save_checkpoint(ckpt, epoch=args.epochs)
    print(f"checkpoint written to {ckpt}")


if __name__ == "__main__":
    main()
