"""Share of the rows the program chunked that are padding
(``padded_row_share.<call>``): 100 x (padded rows - rows) / padded rows,
summed over the ``xpysom.prepare`` spans of the traced calls, in %;
rank 0."""

from _program import calls, named


def read(ctx, part):
    found = calls(part)
    if not found:
        return None
    prep = [r["counts"] for _, recs in found for r in named(recs, "xpysom.prepare")]
    padded = sum(c.get("padded_rows", 0) for c in prep)
    if not padded:
        return None
    return 100.0 * (padded - sum(c.get("rows", 0) for c in prep)) / padded
