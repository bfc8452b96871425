#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``xpysom_dask_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernel library from ``xpysom_dask_tpu_torch/csrc``;
  3. each kernel (K1 packed BMU argmin, K2 its top-2 form, K9 statistics
     scatter) against its plain PyTorch version on the card: the flagship
     shape, a ragged shape and a tie fixture, with CUDA-event timings;
  4. the main path: ``XPySom(128, 128, 64)`` on 2^19 samples, QE before,
     three epochs of a 10-epoch schedule, ``winner``, QE and TE, with the
     kernels' launch counters read around it;
  5. determinism (a second run gives the same codebook bits) and one
     epoch through the plain versions against the kernel path.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(x=128, y=128, d=64, n=1 << 19, chunk=16384)
# The packed mode's stated error floor (xpysom_dask_tpu/ops/pallas/bmu.py
# bmu_euclidean docstring): a winner may differ from the exact one only
# where the two float64 distances are within 2^-17 * sum_d |x_d||2 w_d|.
NEAR_TIE = 2.0**-17
# f32 accumulation of a ~200-term dot product: value tolerance relative
# to the row's term magnitude sum_d |x_d||2 w_d| + |w|^2.
VAL_RTOL = 1e-5
# golden-parity tolerance of tests/test_training_parity.py (allows for
# near-tie flips between two correct argmins)
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-4

REPLACES = {
    "bmu_argmin": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                   "xpysom_dask_tpu/ops/pallas/bmu.py:254"),
    "bmu_top2": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                 "xpysom_dask_tpu/ops/pallas/bmu.py:341"),
    "scatter_stats": ("xpysom_dask_tpu_torch/csrc/stats.cu",
                      "xpysom_dask_tpu/ops/pallas/stats.py:47"),
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, reps=10, warmup=2):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card(torch):
    require(torch.cuda.is_available(), "no CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    return smi


def phase_build():
    from xpysom_dask_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    took = time.perf_counter() - t0
    print(f"build: kernel library ready in {took:.2f} s "
          f"(nvcc {build.last_build_seconds if build.last_build_seconds is not None else 'cached'})")


def _f64_partial(xc, wc):
    """float64 partial squared distances of centered operands (numpy)."""
    return -2.0 * xc @ wc.T + (wc * wc).sum(1)[None, :]


def _check_near_ties(name, rows, xc, wc, got, want):
    """Indices that differ must be float64 near-ties within the packed
    error floor."""
    bad = 0
    for r in rows:
        g, w_ = int(got[r]), int(want[r])
        d = _f64_partial(xc[r : r + 1], wc[[g, w_]])[0]
        floor = NEAR_TIE * max(
            np.abs(xc[r]) @ np.abs(2 * wc[g]), np.abs(xc[r]) @ np.abs(2 * wc[w_])
        )
        if abs(d[0] - d[1]) > floor:
            bad += 1
    require(bad == 0, f"{name}: {bad} of {len(rows)} index differences are not near-ties")


def compare_bmu(torch, kb, name, x, w):
    """Kernel vs plain for K1 and K2 on (x, w), packed as the main path
    packs them; returns the K1/K2 max absolute value errors, the operands
    for timing and K1's indices."""
    xt = torch.from_numpy(x).cuda()
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda())
    a, w_aug, xy = cb.operands(xt)
    center = cb.center.cpu().numpy()
    xc = (x - center).astype(np.float64)
    wc = (w - center).astype(np.float64)

    i_k, v_k = kb.bmu_argmin(a, w_aug, xy)
    i_p, v_p = kb.bmu_argmin_plain(a, w_aug, xy)
    t = kb.bmu_top2(a, w_aug, xy)
    tp = kb.bmu_top2_plain(a, w_aug, xy)
    torch.cuda.synchronize()
    i_k, v_k, i_p, v_p = (u.cpu().numpy() for u in (i_k, v_k, i_p, v_p))
    t = [u.cpu().numpy() for u in t]
    tp = [u.cpu().numpy() for u in tp]
    n = x.shape[0]
    require(i_k.shape == (n,) and np.isfinite(v_k).all(), f"{name}: K1 output malformed")
    require(((i_k >= 0) & (i_k < xy)).all(), f"{name}: K1 index out of range")
    require(((t[2] >= 0) & (t[2] < xy)).all() and (t[0] != t[2]).all(),
            f"{name}: K2 runner-up malformed")

    # value tolerance from each row's term magnitudes
    mag = np.abs(xc) @ np.abs(2 * wc).max(0) + (wc * wc).sum(1).max()
    tol = VAL_RTOL * (1.0 + mag)

    diff1 = np.nonzero(i_k != i_p)[0]
    _check_near_ties(f"{name} K1", diff1, xc, wc, i_k, i_p)
    same = i_k == i_p
    err1 = float(np.abs(v_k - v_p)[same].max()) if same.any() else 0.0
    require((np.abs(v_k - v_p) <= tol)[same].all(), f"{name}: K1 values disagree")
    # K1 and K2 share the GEMM and the first-place order: same winner
    require((t[0] == i_k).all() and np.array_equal(t[1], v_k), f"{name}: K2 first != K1")

    diff2 = np.nonzero((t[0] != tp[0]) | (t[2] != tp[2]))[0]
    _check_near_ties(f"{name} K2 first", diff2, xc, wc, t[0], tp[0])
    _check_near_ties(f"{name} K2 second", diff2, xc, wc, t[2], tp[2])
    same2 = (t[0] == tp[0]) & (t[2] == tp[2])
    err2 = float(max(np.abs(t[1] - tp[1])[same2].max(), np.abs(t[3] - tp[3])[same2].max())) \
        if same2.any() else 0.0
    require((np.abs(t[3] - tp[3]) <= tol)[same2].all(), f"{name}: K2 values disagree")
    print(f"{name}: K1 {len(diff1)} near-tie index differences of {n}, max|dv| {err1:.3g}; "
          f"K2 {len(diff2)} near-tie differences, max|dv| {err2:.3g}")
    return err1, err2, (a, w_aug, xy), i_k


def compare_stats(torch, ks, name, x, m, idx, xy):
    xt, mt = torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda()
    it = torch.as_tensor(idx, dtype=torch.int32).cuda()
    k1 = ks.scatter_stats(xt, mt, it, xy)
    k2 = ks.scatter_stats(xt, mt, it, xy)
    p = ks.scatter_stats_plain(xt, mt, it, xy)
    torch.cuda.synchronize()
    require(torch.equal(k1.view(torch.int32), k2.view(torch.int32)),
            f"{name}: K9 two launches differ in bits")
    require(torch.equal(k1.view(torch.int32), p.view(torch.int32)),
            f"{name}: K9 differs from its plain version in bits")
    require(float(k1[:, -1].sum()) == float(m.sum()), f"{name}: K9 counts lost rows")
    print(f"{name}: K9 bitwise equal to plain and to itself; nodes {xy}, rows {len(idx)}")
    return (xt, mt, it, xy)


def phase_kernels(torch, card):
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    rng = np.random.RandomState(0)
    f = FLAGSHIP
    x = rng.rand(f["chunk"], f["d"]).astype(np.float32)
    w = rng.rand(f["x"] * f["y"], f["d"]).astype(np.float32)
    err1, err2, ops, idx = compare_bmu(torch, kb, "flagship 16384x16384 D=64", x, w)

    xr = rng.rand(1000, 5).astype(np.float32)
    wr = (rng.rand(7 * 13, 5) * 2 - 1).astype(np.float32)
    compare_bmu(torch, kb, "ragged 1000x91 D=5", xr, wr)

    # tie fixture: duplicated codebook rows, first index wins and the
    # duplicate is K2's runner-up
    xt = np.zeros((4, 3), np.float32)
    xt[1] = 5
    wt = np.zeros((2100, 3), np.float32)
    wt[7] = 5
    wt[1500] = 5
    *_, (a, w_aug, xy), _ = compare_bmu(torch, kb, "tie fixture", xt, wt)
    i1, _, i2, v2 = (u.cpu().numpy() for u in kb.bmu_top2(a, w_aug, xy))
    i0, _ = kb.bmu_argmin(a, w_aug, xy)
    require(i0.cpu().numpy().tolist() == [0, 7, 0, 0], f"tie fixture: K1 {i0.tolist()}")
    require(i1.tolist() == [0, 7, 0, 0] and i2.tolist() == [1, 1500, 1, 1],
            f"tie fixture: K2 {i1.tolist()} {i2.tolist()}")

    m = (rng.rand(f["chunk"]) > 0.05).astype(np.float32)
    rand_idx = rng.randint(f["x"] * f["y"], size=f["chunk"])
    compare_stats(torch, ks, "K9 flagship, uniform nodes", x, m, rand_idx, f["x"] * f["y"])
    compare_stats(torch, ks, "K9 flagship, K1's nodes", x, m, idx, f["x"] * f["y"])
    # the main path's first chunk against its initial codebook (the same
    # RandomState draws as XPySom(random_seed=0)): early training sends
    # long runs of rows to a few nodes, the K9 case that costs most
    w0 = np.random.RandomState(0).rand(f["x"], f["y"], f["d"]) * 2 - 1
    w0 = (w0 / np.linalg.norm(w0, axis=-1, keepdims=True)).reshape(-1, f["d"])
    cb0 = kb.PackedCodebook(torch.from_numpy(w0.astype(np.float32)).cuda())
    idx0, _ = kb.bmu_argmin(*cb0.operands(torch.from_numpy(x).cuda()))
    idx0 = idx0.cpu().numpy()
    print(f"K9 main-path chunk: longest run {np.bincount(idx0).max()} rows")
    st = compare_stats(torch, ks, "K9 flagship, initial codebook's nodes", x,
                       np.ones(f["chunk"], np.float32), idx0, f["x"] * f["y"])
    xr9 = rng.rand(1000, 5).astype(np.float32)
    compare_stats(torch, ks, "K9 ragged", xr9, (rng.rand(1000) > 0.2).astype(np.float32),
                  rng.randint(91, size=1000), 91)

    timings = {
        "bmu_argmin": (cuda_ms(torch, lambda: kb.bmu_argmin(*ops)),
                       cuda_ms(torch, lambda: kb.bmu_argmin_plain(*ops))),
        "bmu_top2": (cuda_ms(torch, lambda: kb.bmu_top2(*ops)),
                     cuda_ms(torch, lambda: kb.bmu_top2_plain(*ops))),
        "scatter_stats": (cuda_ms(torch, lambda: ks.scatter_stats(*st)),
                          cuda_ms(torch, lambda: ks.scatter_stats_plain(*st))),
    }
    for name, (ms, plain) in timings.items():
        print(f"time {name} at the flagship chunk: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events; {card})")
    errs = {"bmu_argmin": err1, "bmu_top2": err2, "scatter_stats": 0.0}
    return timings, errs


def phase_main_path(torch):
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    data = np.random.RandomState(0).rand(f["n"], f["d"]).astype(np.float32)
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    som = XPySom(f["x"], f["y"], f["d"], **kw)
    require(som._n_parallel == f["chunk"], f"chunk {som._n_parallel} != {f['chunk']}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    qe0 = som.quantization_error(data)
    print(f"main path: QE before training {qe0:.6f} ({time.perf_counter() - t0:.3f} s)")
    for e in range(3):
        t0 = time.perf_counter()
        som.train(data, 10, iter_beg=e, iter_end=e + 1)
        print(f"main path: epoch {e} of 10 in {time.perf_counter() - t0:.4f} s "
              "(host chunking and upload included)")
    t0 = time.perf_counter()
    win = som.winner(data[:4096])
    qe = som.quantization_error(data)
    te = som.topographic_error(data)
    print(f"main path: winner/QE/TE in {time.perf_counter() - t0:.3f} s; "
          f"QE {qe:.6f} TE {te:.6f}")
    counts = kernels.launch_counts()
    print(f"main path launch counts: {counts}")

    w = som.get_weights()
    require(w.shape == (f["x"], f["y"], f["d"]) and np.isfinite(w).all(),
            "trained codebook malformed")
    require(np.isfinite(qe) and qe < qe0, f"QE did not fall: {qe0} -> {qe}")
    require(0.0 <= te <= 1.0, f"TE {te} outside [0, 1]")
    n_chunks = f["n"] // f["chunk"]
    require(counts["bmu_argmin"] >= 3 * n_chunks, "K1 launched too few times")
    require(counts["scatter_stats"] >= 3 * n_chunks, "K9 launched too few times")
    require(counts["bmu_top2"] >= 1, "K2 never launched")

    # winners against the plain versions on the same codebook
    ref = XPySom.from_numpy(w, **kw, use_kernels=False)
    win_p = ref.winner(data[:4096])
    flat = np.array([a * f["y"] + b for a, b in win])
    flat_p = np.array([a * f["y"] + b for a, b in win_p])
    w_flat = w.reshape(-1, f["d"]).astype(np.float64)
    center = w.reshape(-1, f["d"]).mean(0, dtype=np.float32).astype(np.float64)
    flips = np.nonzero(flat != flat_p)[0]
    _check_near_ties("winner", flips, data[:4096].astype(np.float64) - center,
                     w_flat - center, flat, flat_p)
    print(f"main path: winner agrees with the plain versions on {4096 - len(flips)} "
          f"of 4096; the {len(flips)} others are near-ties")
    return data, kw, w, counts


def phase_determinism(torch, data, kw, w3):
    from xpysom_dask_tpu_torch import XPySom

    f = FLAGSHIP
    again = XPySom(f["x"], f["y"], f["d"], **kw).train(data, 10, iter_end=3)
    require(np.array_equal(again.get_weights().view(np.int32), w3.view(np.int32)),
            "a second run of the same three epochs changed the codebook bits")
    print("determinism: second 3-epoch run bitwise equal")

    k1 = XPySom(f["x"], f["y"], f["d"], **kw).train(data, 10, iter_end=1)
    t0 = time.perf_counter()
    p1 = XPySom(f["x"], f["y"], f["d"], **kw, use_kernels=False).train(data, 10, iter_end=1)
    took = time.perf_counter() - t0
    dw = np.abs(k1.get_weights() - p1.get_weights())
    require(np.allclose(k1.get_weights(), p1.get_weights(), rtol=EPOCH_RTOL, atol=EPOCH_ATOL),
            f"plain epoch disagrees with the kernel epoch: max|dw| {dw.max()}")
    print(f"agreement: plain-version epoch ({took:.3f} s) vs kernel epoch, "
          f"max|dw| {dw.max():.3g} (rtol {EPOCH_RTOL}, atol {EPOCH_ATOL})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    try:
        import xpysom_dask_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    smi = phase_card(torch)
    phase_build()
    timings, errs = phase_kernels(torch, smi)
    data, kw, w3, counts = phase_main_path(torch)
    phase_determinism(torch, data, kw, w3)
    require("jax" not in sys.modules, "JAX was imported")

    record = {
        "card": smi,
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": REPLACES[name][0],
                "replaces": REPLACES[name][1],
                "launches": counts[name],
                "max_abs_err": errs[name],
                "ms": timings[name][0],
                "plain_ms": timings[name][1],
            }
            for name in ("bmu_argmin", "bmu_top2", "scatter_stats")
        ],
    }
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
