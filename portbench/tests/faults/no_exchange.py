"""Fault: the exchange between ranks is left out (every all_reduce of
the statistics and the scores returns this rank's own)."""
from xpysom_dask_tpu_torch.parallel import mesh


def _own(tensor, m):
    return tensor


mesh.all_reduce_sum = _own
