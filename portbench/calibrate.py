"""Readings from which a cell's limits are set (``limits/<cell>.json``):
the numbers the check compares, for sound runs of the program on many
seeds, for the configuration's lower-precision control and for planted
faults, all at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --first-seed <n>
        [--program 12] [--control 3] [--plant tests/faults/half_batch.py --planted 3]
        [--seconds 5]

Each reading of the program is a whole run of the cell through the
benchmark's own entry (``launch.run``: set-up, a window of ``--seconds``
and the check), one seed each; ``--seconds 0`` gives a fit cell's window
one job. The control is the program with the configuration's
``control.som`` arguments where it has that path
(``bmu_precision='bf16'``), else the reference with its search in
``control.reference_search`` put in the program's place (a fit cell
only). A planted fault is planted once, before the first planted
reading, in this process (one card) or in every rank (more). One JSON
line a reading. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(ROOT)
sys.path.insert(0, ROOT)
sys.path.insert(0, CHECKOUT)

from harness import cell, check, launch, manifest  # noqa: E402


def _reference_control(spec: dict, search: str) -> dict:
    """The fit job worked out by the reference with its search in
    ``search`` (a torch dtype's name), judged as the program's job is."""
    import torch

    config, mix, seed = spec["config"], spec["mix"], int(spec["seed"])
    if mix["kind"] != "fit":
        raise ValueError("the reference serves as the control of fit cells only")
    dev = torch.device(spec["device"])
    ref = cell.load_file_module(os.path.join(ROOT, config["reference"]), "portbench_reference")
    cfg = ref.SomConfig.from_som_kwargs(config["som"])
    X = cell.make_rows(torch, dev, seed, int(config["n_samples"]), cfg.input_len)
    w0 = cell.initial_codebook(X, cfg.x, cfg.y, seed)
    dtype, epochs = getattr(torch, search), int(mix["epochs"])
    Xd = torch.from_numpy(X).to(dev)
    w = torch.from_numpy(w0).to(dev).double()
    states = {0: w0}
    for t in range(epochs):
        w = ref.step(cfg, Xd, w, t, epochs, dtype)
        states[t + 1] = w.float().cpu().numpy()
    qe = ref.quantization_error(Xd, w, dtype)
    te = ref.topographic_error(Xd, w, cfg.y, dtype)
    del Xd, w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return check.fit_numbers(torch, ref, cfg, dev, X, epochs, states, states[epochs], qe, te,
                             config.get("checked_epochs", check.EPOCHS))


def reading(spec: dict, variant: str = "program"):
    """``(exit code, numbers)`` of one reading: ``variant`` ``"program"``
    or ``"control"``; a fault planted beforehand reads as the program."""
    search = spec["config"].get("control", {}).get("reference_search")
    if variant == "control" and search:
        return 0, _reference_control(spec, search)
    code, result, _ = launch.run(dict(spec, variant=variant, all_numbers=True))
    return code, result and result["numbers"]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--plant", default=None, help="a fault file, relative to portbench/")
    p.add_argument("--planted", type=int, default=0)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal at a small size only")
    args = p.parse_args()
    launch.pin_caches(CHECKOUT)
    spec = manifest.run_spec(CHECKOUT, args.workload, args.first_seed, args.seconds, False)
    spec["device"] = args.device
    import torch

    card = torch.cuda.get_device_name(0) if args.device == "cuda" and torch.cuda.is_available() else None
    runs = ["program"] * args.program + ["control"] * args.control + ["planted"] * args.planted
    planted = False
    for k, variant in enumerate(runs):
        one = dict(spec, seed=args.first_seed + k, started=time.time())
        if variant == "planted" and not planted:
            if int(spec["world"]) == 1:
                runpy.run_path(os.path.join(ROOT, args.plant), run_name="portbench_plant")
            else:
                spec["plant"] = one["plant"] = os.path.join(ROOT, args.plant)
            planted = True
        t0 = time.perf_counter()
        code, numbers = reading(one, "control" if variant == "control" else "program")
        print(json.dumps({"workload": args.workload, "variant": variant,
                          "plant": args.plant if variant == "planted" else None, "seed": one["seed"],
                          "numbers": numbers, "code": code, "seconds": time.perf_counter() - t0,
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
