#!/usr/bin/env python3
"""Time and profile one flagship training epoch of the PyTorch port
(``xpysom_dask_tpu_torch``) on a CUDA card. Run from the repository root:

    python3 profile_torch_epoch.py [--activation NAME] [--trace PATH]

Prints the card, the host-clock time of three epochs with the kernels and
with their plain versions (device-resident chunks, synchronized), the
time of BMU search, QE and TE over all samples, K9's time per chunk with a
warm and a flushed L2, and a torch.profiler table of one epoch with the
device busy time. ``--activation`` trains under another activation
distance (default euclidean; ``manhattan`` searches with K5), ``--trace``
also writes the chrome trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from xpysom_dask_tpu_torch import XPySom, core
from xpysom_dask_tpu_torch.ops.kernels import stats as ks


def _busy_us(events):
    """Union of the device intervals of ``events`` (microseconds) and the
    span from the first start to the last end."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, (iv[-1][1] - iv[0][0]) if iv else 0


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--activation", default="euclidean",
                    help="the activation distance to train under (default euclidean)")
    ap.add_argument("--trace", help="write the chrome trace of the profiled epoch here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_epoch: no CUDA card")
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("card:", smi)
    print("activation:", args.activation)
    data = np.random.RandomState(0).rand(1 << 19, 64).astype(np.float32)
    som = XPySom(128, 128, 64, sigma=64, sigmaN=1, learning_rate=0.5,
                 learning_rateN=0.01, random_seed=0, activation_distance=args.activation)
    (chunks, mask, _), took = _timed(som._chunked, data)
    print(f"host chunk_data + upload: {took:.4f} s")
    spec = som._spec
    w = som._device_weights()
    for label, sp in (("kernels", spec),
                      ("plain", dataclasses.replace(spec, use_kernels=False))):
        step = core.make_epoch_step(sp, 10)
        ww = step(w, chunks, mask, 0)  # warm-up
        times = []
        for t in range(1, 4):
            ww, took = _timed(step, ww, chunks, mask, t)
            times.append(took)
        print(f"epoch ({label}) host-clock seconds: {times}")

    for name, fn, fargs in (
        ("QE", core.make_quantization_stats_fn(spec), (w, chunks, mask)),
        ("TE", core.make_topographic_stats_fn(spec), (w, chunks, mask)),
        ("BMU", core.make_bmu_fn(spec), (w, chunks)),
    ):
        fn(*fargs)
        print(f"{name} over 2^19 samples: {_timed(fn, *fargs)[1]:.4f} s")

    # K9 per chunk on the first epoch's nodes, warm and after an L2 flush
    cb = core._searcher(spec, spec.distance_fn(), w.reshape(spec.xy, spec.input_len))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=w.device)
    rows = []
    for c in range(0, chunks.shape[0], 4):
        x, m = chunks[c], mask[c]
        idx = core._bmu_chunk(spec, cb, x)
        longest = int(torch.bincount(idx.long()).max())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ks.scatter_stats(x, m, idx, spec.xy)
        torch.cuda.synchronize()
        ev[0].record()
        ks.scatter_stats(x, m, idx, spec.xy)
        ev[1].record()
        flush.fill_(1.0)
        ev[2].record()
        ks.scatter_stats(x, m, idx, spec.xy)
        ev[3].record()
        torch.cuda.synchronize()
        rows.append((c, longest, ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])))
    print("K9 per chunk (chunk, longest run, warm ms, flushed-L2 ms):", rows)

    step = core.make_epoch_step(spec, 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(step, w, chunks, mask, 1)
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=12))
    device = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy, span = _busy_us(device)
    print(json.dumps({"card": smi, "epoch_wall_s": wall, "device_busy_us": busy,
                      "device_span_us": span, "device_events": len(device)}))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
