"""Read ``BENCHMARK.json`` and the files it names, and make the spec of
one run (``cell.run``). Everything that belongs to one configuration,
traffic mix, cell or metric is found by its name:

- a configuration: the file its ``configs`` entry names;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a cell's limits on the numbers it compares: ``portbench/limits/<cell>.json``;
- a metric: ``portbench/metrics/<name>.py``, else
  ``portbench/metrics/<name up to the first dot>.py``.
"""

from __future__ import annotations

import json
import os

__all__ = ["load", "cell_metrics", "run_spec"]


def load(checkout: str) -> dict:
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, group: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it under ``workloads``, and those without the key."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def run_spec(checkout: str, workload: str, seed: int, seconds: float, trace: bool) -> dict:
    bench = load(checkout)
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "configuration")
    root = os.path.join(checkout, "portbench")
    with open(os.path.join(checkout, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", f"{cell['traffic']}.json")) as f:
        mix = json.load(f)
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    return {
        "root": root, "cell": cell, "config": config, "mix": mix, "limits": limits,
        "metrics": cell_metrics(bench, workload, "per_layer" if trace else "end_to_end"),
        "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
        "device": "cuda", "world": int(cell["chips"]), "variant": "program",
    }
