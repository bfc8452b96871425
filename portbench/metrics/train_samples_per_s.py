"""Rows times epochs trained, over the wall time of every ``train`` call
in the window (host clock; a mesh's slowest rank, all its rows)."""

from _common import spans, wall_s


def read(ctx, part):
    per_rank = spans(ctx, "train")
    if not per_rank[0]:
        return None
    work = sum(s["rows"] * s["epochs"] for s in per_rank[0])
    return work / max(sum(wall_s(s) for s in rank) for rank in per_rank)
