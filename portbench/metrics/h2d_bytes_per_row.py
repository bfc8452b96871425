"""Bytes the program copied to the device (the ``bytes`` of its
``xpysom.upload`` spans: chunks, mask and codebook) per row the traced
calls were given (the ``rows`` of each call span;
``h2d_bytes_per_row.<call>``); rank 0."""

from _program import calls, named


def read(ctx, part):
    found = calls(part)
    if not found:
        return None
    rows = sum(root["counts"].get("rows", 0) for root, _ in found)
    sent = sum(r["counts"].get("bytes", 0) for _, recs in found for r in named(recs, "xpysom.upload"))
    return sent / rows if rows else None
