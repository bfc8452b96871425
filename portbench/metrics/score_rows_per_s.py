"""Rows scored over the wall time of the window's quantization- and
topographic-error calls (each job scores its rows once with both; host
clock; a mesh's slowest rank)."""

from _common import spans, wall_s


def read(ctx, part):
    per_rank = spans(ctx, "score")
    if not per_rank[0]:
        return None
    rows = sum(s["rows"] for s in per_rank[0] if s["kind"] == "qe")
    return rows / max(sum(wall_s(s) for s in rank) for rank in per_rank)
