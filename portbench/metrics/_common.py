"""Helpers the metric readers share. A reader is ``read(ctx, part)``
(``harness.cell.Context``; ``part`` is the metric's name after its first
dot, or None) and returns a number, or None where its run has nothing
for it to read."""

# the calls a part of a metric's name stands for
CALLS = {"train": ("train",), "score": ("qe", "te"), "predict": ("predict",)}


def spans(ctx, part):
    """Each rank's host-clock spans of the calls ``part`` names."""
    kinds = CALLS[part]
    return [[s for s in rank if s["kind"] in kinds] for rank in ctx.spans]


def calls(ctx, part):
    """Each rank's traced calls that ``part`` names (None untraced)."""
    if ctx.calls is None:
        return None
    kinds = CALLS[part]
    return [[c for c in rank if c["kind"] in kinds] for rank in ctx.calls]


def traced_spans(ctx, part):
    """Rank 0's traced calls beside its host spans of the same calls (the
    rows and epochs of each call)."""
    kinds = CALLS[part]
    host = [s for s in ctx.spans[0] if s["kind"] in kinds]
    traced = [c for c in ctx.calls[0] if c["kind"] in kinds]
    return list(zip(host, traced))


def wall_s(span):
    return span["t1"] - span["t0"]
