"""Device time of host-to-device copies per call (``h2d_ms.<call>``:
``train``, ``score`` or ``predict``), from the trace; rank 0."""

from _common import calls


def read(ctx, part):
    traced = calls(ctx, part)
    if not traced or not traced[0]:
        return None
    return 1e3 * sum(c["h2d_s"] for c in traced[0]) / len(traced[0])
