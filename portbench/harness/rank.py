"""One rank of a multi-card cell: ``python rank.py <spec.json> <rank>``
(started by ``launch.py``). Rank 0 prints the result after
``launch.RESULT_MARK``; its other output, and every other rank's, goes
to standard error. Exit codes as ``run.py``'s."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import cell, launch  # noqa: E402


def main(path: str, rank: int) -> int:
    with open(path) as f:
        spec = json.load(f)
    spec["rank"] = rank
    if spec["device"] == "cuda":
        import torch

        why = launch.cards_missing(torch, int(spec["world"]))
        if why:
            print(f"portbench: rank {rank}: {why}", file=sys.stderr)
            return 3
    out = cell.run(spec)
    if out is not None:
        result, found = out
        print(launch.RESULT_MARK + json.dumps({"result": result, "found": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
