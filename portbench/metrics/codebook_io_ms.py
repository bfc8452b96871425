"""Host time of the codebook's trips across the bus per call
(``codebook_io_ms.<call>``): the program's ``xpysom.upload`` spans that
count ``units`` (the codebook's upload; the rows' uploads count none) and
its ``xpysom.fetch`` spans that count ``bytes`` (the codebook fetched
after ``train``), the mean over the traced calls; rank 0. None where the
program's spans carry neither count (a program older than them)."""

from _program import calls


def _codebook(rec):
    counts = rec["counts"]
    return ((rec["name"] == "xpysom.upload" and "units" in counts)
            or (rec["name"] == "xpysom.fetch" and "bytes" in counts))


def read(ctx, part):
    found = calls(part)
    if not found:
        return None
    moved = [[r for r in recs if _codebook(r)] for _, recs in found]
    if not any(moved):
        return None
    return 1e3 * sum(r["t1"] - r["t0"] for recs in moved for r in recs) / len(moved)
