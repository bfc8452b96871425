"""The share of the traced calls' K1 and K2 launches that streamed A
beside each codebook chunk (``streamed_search_share.<call>``), in %: the
``streamed_searches`` over the ``searches`` that the program's call spans
count; rank 0. None where the call spans carry no such counts (a program
older than them) or the calls launched no search."""

from _program import calls


def read(ctx, part):
    found = calls(part)
    if not found:
        return None
    counted = [root["counts"] for root, _ in found if "searches" in root["counts"]]
    searches = sum(c["searches"] for c in counted)
    if not searches:
        return None
    return 100.0 * sum(c["streamed_searches"] for c in counted) / searches
