"""Fault: the cosine route searches by euclidean distance: each epoch's
codebook is the euclidean one, centred, in place of the normalised
directions."""
from xpysom_dask_tpu_torch.ops.kernels import bmu


def _euclidean_codebook(w_flat, mode="packed"):
    return bmu.PackedCodebook(w_flat, mode)


bmu.cosine_codebook = _euclidean_codebook
