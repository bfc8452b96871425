"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``xpysom_dask_tpu_torch``). It needs as many CUDA cards as
the cell asks for, and prints one JSON line last on standard output (the
numbers compared, each beside its limit, last on standard error). Exit
codes: 0 a result, 2 a bad argument or missing file, 3 too few cards, 4
a forbidden module loaded, 1 anything else.
"""

import time

STARTED = time.time()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(ROOT)
sys.path.insert(0, ROOT)

from harness import guard, launch, manifest  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        spec = manifest.run_spec(CHECKOUT, args.workload, args.seed, args.seconds, bool(args.trace))
    except (OSError, KeyError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    spec["started"] = STARTED
    # a terminated run still stops the processes it started (launch.run's finally)
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    launch.pin_caches(CHECKOUT)
    code, result, found = launch.run(spec)
    found = sorted(set(found) | set(guard.forbidden_modules()))
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    if code != 0 or result is None:
        return code or 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
