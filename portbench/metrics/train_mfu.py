"""The least time of the traced ``train`` calls' work (``work/``, at the
published peaks) over their wall time, in %: the whole call's share of
the card's peak; rank 0."""

from _common import traced_spans


def read(ctx, part):
    if ctx.calls is None:
        return None
    pairs = traced_spans(ctx, "train")
    wall = sum(c["wall_s"] for _, c in pairs)
    if not pairs or wall <= 0:
        return None
    return 100.0 * sum(ctx.least_s(s) for s, _ in pairs) / wall
