"""The least time the traced calls' work needs (``work/``, from shapes
alone, at the published peaks) over the time in which their kernels ran,
in % (``kernels_roofline.<call>``); rank 0."""

from _common import traced_spans


def read(ctx, part):
    if ctx.calls is None:
        return None
    pairs = traced_spans(ctx, part)
    busy = sum(c["kernel_busy_s"] for _, c in pairs)
    if not pairs or busy <= 0:
        return None
    return 100.0 * sum(ctx.least_s(s) for s, _ in pairs) / busy
