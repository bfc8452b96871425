"""The 95th percentile of every ``predict`` request's latency in the
window, from the call to its return (host clock), nearest rank."""

import math

from _common import spans, wall_s


def read(ctx, part):
    lat = sorted(wall_s(s) for s in spans(ctx, "predict")[0])
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
