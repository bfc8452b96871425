"""Least work of the batch SOM under the manhattan activation, from
shapes alone (see ``euclidean.py`` for the resources). The search is
``n·xy·d`` terms ``|x_d - w_d|`` at two FP32 instructions a term (a
subtract and an add of the absolute value) on the CUDA cores; no tensor
core computes it. Statistics and update are the euclidean ones."""

from . import euclidean as _e

stats = _e.stats
update = _e.update
add = _e.add


def search(n, xy, d):
    return {"fp32_instr": 2.0 * n * xy * d, "bytes": 4.0 * (n * d + xy * d)}


def epoch(n, x, y, d):
    return add(search(n, x * y, d), stats(n, x * y, d), update(x, y, d))
