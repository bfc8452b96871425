"""The one generator of the benchmark's traffic. A mix is a data file,
``traffic/<name>.json``, of parameters; this module reads it and makes
the work from ``--seed``. Two kinds:

``fit``: one job, repeated until the window closes (a closed loop, one
client): the codebook set back to the set-up's initial codebook, then
``train(X, epochs)``, ``quantization_error(X)`` and
``topographic_error(X)`` on the configuration's rows. ``mesh`` (null or
``"auto"``) is passed to ``XPySom``: ``"auto"`` runs one process a card,
each training on its block of the rows.

``predict``: ``predict(rows)`` requests, one after the other with no
think time (a closed loop, one client), drawn from a pool of
``pool_rows`` rows. Every seed gets the same set of request sizes,
``sizes`` quantiles of the log-uniform law on ``[min_rows, max_rows]``,
in an order and at pool offsets drawn from the seed: the seed changes
which rows are asked for, not how much work is asked. The window runs
through the list again and again.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["rng", "request_sizes", "request_plan", "check_sample"]


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of ``seed``."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def request_sizes(mix: dict) -> np.ndarray:
    """The mix's request sizes, in rows: ``sizes`` quantiles of the
    log-uniform law on ``[min_rows, max_rows]``, rounded."""
    lo, hi, k = math.log(mix["min_rows"]), math.log(mix["max_rows"]), int(mix["sizes"])
    q = (np.arange(k) + 0.5) / k
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


def request_plan(mix: dict, seed: int) -> list:
    """One pass of the requests: ``(offset, rows)`` pairs, the sizes in
    an order and at offsets drawn from ``seed``."""
    sizes = request_sizes(mix)
    g = rng(seed, 2)
    order = g.permutation(len(sizes))
    starts = g.integers(0, mix["pool_rows"] - sizes[order] + 1)
    return [(int(o), int(n)) for o, n in zip(starts, sizes[order])]


def check_sample(mix: dict, seed: int, count: int = 1 << 20) -> np.ndarray:
    """Which requests the check compares, by their index in the window: a
    share ``check_share`` drawn from ``seed`` (the window also keeps the
    last ``check_last``)."""
    return rng(seed, 3).random(count) < mix["check_share"]
