"""Kernels launched by the traced ``train`` calls, per epoch trained;
rank 0."""

from _common import traced_spans


def read(ctx, part):
    if ctx.calls is None:
        return None
    pairs = traced_spans(ctx, "train")
    epochs = sum(s["epochs"] for s, _ in pairs)
    return sum(c["kernels"] for _, c in pairs) / epochs if epochs else None
