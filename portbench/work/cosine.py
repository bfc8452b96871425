"""Least work of the batch SOM under the cosine activation, from shapes
alone (see ``euclidean.py`` for the resources). The search is the
euclidean one's ``2·n·xy·d`` GEMM (``x·w_hat``), plus the codebook's
normalisation: each code vector's norm and its scaling, two FP32
instructions an element (a multiply-add into the norm, a multiply by its
inverse); the rows and the codebook read once. Statistics and update are
the euclidean ones."""

from . import euclidean as _e

stats = _e.stats
update = _e.update
add = _e.add


def search(n, xy, d):
    return add(_e.search(n, xy, d), {"fp32_instr": 2.0 * xy * d})


def epoch(n, x, y, d):
    return add(search(n, x * y, d), stats(n, x * y, d), update(x, y, d))
