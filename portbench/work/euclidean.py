"""Least work of the batch SOM under the euclidean activation, from
shapes alone: what any implementation must do, never what the program
launches (the packed search's K = 208 columns are the implementation's).

Each function returns ``{resource: amount}``: ``tensor_flops`` (at the
dense bf16 peak), ``fp32_instr`` (FP32 instructions on the CUDA cores)
and ``bytes`` (HBM traffic, each input read once, each output written
once). The harness turns a call's sum into the least time as the
largest of amount over peak across the resources, so a fused
implementation that overlaps stages still cannot read above 100%.
"""


def search(n, xy, d):
    """The nearest of ``xy`` units for ``n`` rows: one ``2·n·xy·d`` GEMM
    (``-2 x·w + |w|^2``), the rows and the codebook read once."""
    return {"tensor_flops": 2.0 * n * xy * d, "bytes": 4.0 * (n * d + xy * d)}


def stats(n, xy, d):
    """Per-unit sums and counts: ``[x | 1]`` read once (the 1 is
    implicit), ``[S | cnt]`` written once."""
    return {"bytes": 4.0 * n * d + 4.0 * xy * (d + 1)}


def update(x, y, d):
    """The gaussian update on a rectangular grid: the operator is
    separable, two passes of ``2·X·X·Y`` and ``2·X·Y·Y`` multiply-adds
    over ``d + 1`` columns; ``[S | cnt]`` and the codebook read, the new
    codebook written."""
    xy = x * y
    return {"tensor_flops": 2.0 * (x * x * y + x * y * y) * (d + 1),
            "bytes": 4.0 * (xy * (d + 1) + 2 * xy * d)}


def epoch(n, x, y, d):
    """One training epoch: search, statistics and update."""
    return add(search(n, x * y, d), stats(n, x * y, d), update(x, y, d))


def add(*works):
    out = {}
    for w in works:
        for k, v in w.items():
            out[k] = out.get(k, 0.0) + v
    return out
