"""Host time of the program's ``xpysom.prepare`` spans (``core.chunk_data``'s
zeroed padded copy of the rows) per call (``host_prep_ms.<call>``:
``train``, ``score`` or ``predict``), the mean over the traced calls;
rank 0."""

from _program import calls, named


def read(ctx, part):
    found = calls(part)
    if not found:
        return None
    prep = [sum(r["t1"] - r["t0"] for r in named(recs, "xpysom.prepare")) for _, recs in found]
    return 1e3 * sum(prep) / len(prep)
