"""Boolean env-switch parsing.

The common shell idiom ``FLAG=0`` means OFF; bare string truthiness would
read it as ON (a user exporting ``XPYSOM_TPU_NO_PALLAS=0`` to be explicit
would silently disable every fused kernel). One parser, used by every
boolean ``XPYSOM_*`` switch, mirroring ``core._use_split_scatter``'s
0/1 handling.
"""

from __future__ import annotations

import os

__all__ = ["env_flag", "env_tristate"]

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str) -> bool:
    """True iff ``name`` is set to a truthy value (unset, '', '0',
    'false', 'no', 'off' — case-insensitive — are all False)."""
    return os.environ.get(name, "").strip().lower() not in _FALSY


def env_tristate(name: str):
    """None when unset/empty (caller's auto default), else the same
    truthiness rule as :func:`env_flag` — for force-on/force-off hooks
    like ``XPYSOM_SPLIT_SCATTER``."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    return raw.strip().lower() not in _FALSY
