"""Device-busy time (kernels, copies and sets) of the traced ``train``
calls, per epoch trained; rank 0."""

from _common import traced_spans


def read(ctx, part):
    if ctx.calls is None:
        return None
    pairs = traced_spans(ctx, "train")
    epochs = sum(s["epochs"] for s, _ in pairs)
    return 1e3 * sum(c["busy_s"] for _, c in pairs) / epochs if epochs else None
