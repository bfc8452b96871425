"""Fault: ``train`` returns its codebook unchanged."""
from xpysom_dask_tpu_torch import core


def _make_train_fn(spec, num_epochs, mesh=None):
    def run(w, data, mask, iter_beg, iter_end, progress=None):
        return w

    return run


core.make_train_fn = _make_train_fn
