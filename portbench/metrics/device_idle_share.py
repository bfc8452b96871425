"""Share of the traced calls' wall time (``device_idle_share.<call>``) in
which the device ran no kernel, copy or set, in %; rank 0."""

from _common import calls


def read(ctx, part):
    traced = calls(ctx, part)
    if not traced or not traced[0]:
        return None
    wall = sum(c["wall_s"] for c in traced[0])
    return 100.0 * (1.0 - sum(c["busy_s"] for c in traced[0]) / wall)
