#!/usr/bin/env python
"""Color quantization (reference examples/ColorQuantization.ipynb
workload): learn a small RGB codebook from image pixels and requantize.
The PyTorch port's twin of examples/color_quantization.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch.utils import resolve_device


def synth_image(h=128, w=128):
    """Synthetic smooth RGB image (no bundled image assets)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.sin(xx / 17) * 0.5 + 0.5
    g = np.cos(yy / 11) * 0.5 + 0.5
    b = ((xx + yy) % 64) / 64
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device, e.g. 'cpu' (default: the CUDA card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device={device}")

    img = synth_image()
    pixels = img.reshape(-1, 3)

    som = XPySom(4, 4, 3, sigma=1.5, neighborhood_function="bubble", random_seed=3,
                 device=device)
    som.train(pixels, 15)

    quantized = som.quantization(pixels).reshape(img.shape)
    mse = float(np.mean((img - quantized) ** 2))
    print(f"16-color quantization MSE: {mse:.5f}")
    print("palette:")
    print(np.round(som.get_weights().reshape(-1, 3), 3))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        fig, ax = plt.subplots(1, 2, figsize=(8, 4))
        ax[0].imshow(img)
        ax[0].set_title("original")
        ax[1].imshow(np.clip(quantized, 0, 1))
        ax[1].set_title("quantized (16 colors)")
        for a in ax:
            a.axis("off")
        plt.savefig(os.path.join(out, "color_quantization.png"), dpi=100)
        print("wrote", os.path.join(out, "color_quantization.png"))
    except ImportError:
        pass


if __name__ == "__main__":
    main()
