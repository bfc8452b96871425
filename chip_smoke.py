#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``xpysom_dask_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernel library from ``xpysom_dask_tpu_torch/csrc``;
  3. K1 (packed BMU argmin) and K2 (its top-2 form) against their plain
     PyTorch versions on the card (the flagship shape, a ragged shape and
     a tie fixture), then K9 (statistics scatter) bitwise against its
     plain version and a second launch on the three flagship chunks
     (uniform nodes, K1's nodes, the initial codebook's) and on fixtures
     (ragged, every row on one node, D = 512 with its column passes,
     out-of-range int32 and int64 indices), with CUDA-event timings of
     each flagship chunk beside ``index_add_`` and torch.profiler splits
     by kernel name of one call of each;
  4. K4 (the f32-accuracy GEMM argmin on the TF32 tensor cores) and the
     register-tiled kernels (K5 L1, K6 odd p = 3, K7 fractional p = 1.5
     (its sqrt branch) and 2.7 (exp/log)) against their plain versions:
     the flagship chunk, K4 at the even-p expansion's width (p = 4,
     D' = 320) held to K4's stated envelope plus cuBLAS's f32 bound, a
     ragged shape and a tie and zero-distance fixture, K4's TF32 split
     bit for bit against the rounding on the bits, with CUDA-event
     timings beside the library call (K4 beside ``addmm`` + ``argmin``,
     with its three-pass TF32 bound and the FP32 FFMA bound);
  5. the other precision modes' kernels: K3 (split3) and K1/K2 under the
     bf16 and split2 operands against their plain versions (flagship,
     ragged, tie fixture), and K8 (the L1 matrix) bitwise against its
     plain version (flagship, ragged), with CUDA-event timings;
  6. the main path: ``XPySom(128, 128, 64)`` on 2^19 samples, QE before,
     three epochs of a 10-epoch schedule, ``winner``, QE and TE, with the
     kernels' launch counters read around it;
  7. determinism (a second run gives the same codebook bits) and one
     epoch through the plain versions against the kernel path;
  8. the rectangular packed path, the ``bmu_precision='split3'`` path and
     the hexagonal path at the same width (QE, 2 of 10 epochs,
     winner/QE/TE, counters; split3's winners against the plain versions';
     the other two paths' QE and codebooks against the rectangular one's)
     and their epoch times on device-resident chunks;
  9. the manhattan main path at the same width (QE, 2 of 10 epochs,
     winner/QE/TE, counters, winners against the plain versions) and its
     epoch time on device-resident chunks;
 10. shorter runs (2^16 samples, one epoch) under cosine, norm_p with
     p = 3, 1.5 and 4, euclidean with ``bmu_precision='highest'``,
     ``'bf16'``, ``'split2'``, and ``'margin'`` under euclidean and cosine:
     QE falls, the route's kernel launches, and the winners agree with
     the plain versions' (margin's with the float64 argmin);
 11. ``margin`` on one flagship chunk of clustered data whose suspects fit
     the rescue buffer: the compacted re-rank runs, its winners equal the
     plain versions' and the float64 argmin up to the packed floor, and
     its parts and the host read of the suspect count are timed;
 12. ``activate`` under manhattan on 8192 samples x 16384 nodes: K8
     launches and the matrix equals the plain versions' bit for bit; K8
     timed at activate's own chunk;
 13. the wide-D search (K1-kb): ``PackedCodebook.argmin(kblock=)`` at
     (16384, 16384, 512) and (16384, 4096, 1024), modes packed and bf16,
     kblock 512 and 1024, winners and values against the plain version and
     K1, a ragged shape, a tie fixture across slabs, the validation errors,
     CUDA-event timings of K1-kb, K1 and the plain version;
 14. the fused-statistics epoch (K10): two epochs of the flagship
     (128x128x64, 2^19 samples, chunk 16384) whose statistics come from
     K10, bitwise equal to the same epochs from K1 + K9 and to a second
     run; K10 bitwise against K1 + K9 on a uniform, a ragged and the
     skewed first chunk, timed per chunk against K1 + K9.
Each kernel's record carries its launches on the path that runs it, its
error against the plain version, its time, the plain version's, the time
of one PyTorch library call that computes the same function where there
is one, and its bound: the least time the card could take, from this
run's shapes and the H100's published peaks.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

import json
import re
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

# an f32 FFMA dot product of D terms (K4's cuBLAS plain version) errs by
# at most D * 2^-24 * sum_d |x_d||2 w_d|
F32_DOT = 2.0**-24
# K7 (accurate expf/logf, a few ulp per term): the JAX tests' near-tie
# margin (tests/test_pallas.py, relative float64 runner-up margin) and
# value tolerance
FRAC_MARGIN, FRAC_RTOL = 1e-4, 1e-5
# the bf16 pass's pairwise error envelope (mode 'margin''s gate, 6 u)
MARGIN_GATE = 6.0 * 2.0**-8

REPLACES = {
    "bmu_argmin": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                   "xpysom_dask_tpu/ops/pallas/bmu.py:254"),
    "bmu_top2": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                 "xpysom_dask_tpu/ops/pallas/bmu.py:341"),
    "scatter_stats": ("xpysom_dask_tpu_torch/csrc/stats.cu",
                      "xpysom_dask_tpu/ops/pallas/stats.py:47"),
    "bmu_highest": ("xpysom_dask_tpu_torch/csrc/highest.cu",
                    "xpysom_dask_tpu/ops/pallas/bmu.py:439"),
    "bmu_manhattan": ("xpysom_dask_tpu_torch/csrc/elementwise.cu",
                      "xpysom_dask_tpu/ops/pallas/bmu.py:1019"),
    "bmu_norm_p_odd": ("xpysom_dask_tpu_torch/csrc/elementwise.cu",
                       "xpysom_dask_tpu/ops/pallas/bmu.py:1111"),
    "bmu_norm_p_frac": ("xpysom_dask_tpu_torch/csrc/elementwise.cu",
                        "xpysom_dask_tpu/ops/pallas/bmu.py:1175"),
    "bmu_split3": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                   "xpysom_dask_tpu/ops/pallas/bmu.py:212"),
    "manhattan_distance": ("xpysom_dask_tpu_torch/csrc/manhattan.cu",
                           "xpysom_dask_tpu/ops/pallas/manhattan.py:32"),
    "bmu_argmin_kb": ("xpysom_dask_tpu_torch/csrc/bmu.cu",
                      "xpysom_dask_tpu/ops/pallas/bmu.py:292"),
    "bmu_stats_fused": ("xpysom_dask_tpu_torch/csrc/fused_stats.cu",
                        "xpysom_dask_tpu/ops/pallas/fused_stats.py:75"),
}
# the wide-D shapes of tools/r4_kblock.py: (samples, nodes, D)
WIDE_SHAPES = ((16384, 16384, 512), (16384, 4096, 1024))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet;
# the special-function rate from the Hopper white paper: 16 units per SM,
# 132 SMs, 1.98 GHz boost clock). A bound is the larger of the operations'
# time at these rates and the bytes' time (each input read once, each
# output written once) at the memory rate.
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12  # an FMA counts as two
FP32_INSTR = FP32_FLOPS / 2  # FP32 instructions per second
SFU_RATE = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12
# bf16 unit roundoff: the bf16 pass's error envelope is ~2.1 u per term
F32_U = 2.0**-24


def bound(op_seconds, nbytes):
    """``(bound_ms, bound_by)``: the larger of the operations' time and the
    bytes' time at the memory rate."""
    t_bytes = nbytes / HBM_BYTES
    return max(op_seconds, t_bytes) * 1e3, ("operations" if op_seconds >= t_bytes else "bytes")


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


def compare_stats(torch, ks, name, x, m, idx, xy, dtype=None):
    """K9 against its plain version and a second launch, bit for bit;
    returns the device operands."""
    xt, mt = torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda()
    it = torch.as_tensor(idx, dtype=dtype or torch.int32).cuda()
    k1 = ks.scatter_stats(xt, mt, it, xy)
    k2 = ks.scatter_stats(xt, mt, it, xy)
    p = ks.scatter_stats_plain(xt, mt, it, xy)
    torch.cuda.synchronize()
    require(k1.shape == (xy, x.shape[1] + 1), f"{name}: K9 shape {tuple(k1.shape)}")
    require(torch.equal(k1.view(torch.int32), k2.view(torch.int32)),
            f"{name}: K9 two launches differ in bits")
    require(torch.equal(k1.view(torch.int32), p.view(torch.int32)),
            f"{name}: K9 differs from its plain version in bits")
    valid = (np.asarray(idx) >= 0) & (np.asarray(idx) < xy)
    require(float(k1[:, -1].sum()) == float(m[valid].sum()), f"{name}: K9 counts lost rows")
    print(f"{name}: K9 bitwise equal to plain and to itself; nodes {xy}, rows {len(idx)}, "
          f"D {x.shape[1]}, longest run {int(np.bincount(np.asarray(idx)[valid]).max())}")
    return (xt, mt, it, xy)


def _profile_split(torch, fn):
    """Device microseconds of one call of ``fn`` by kernel name
    (torch.profiler; names cut to 60 characters). The trace sometimes
    comes back without device events; up to three tries."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    split = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                name = e.name[:60]
                split[name] = round(split.get(name, 0.0) + e.time_range.end - e.time_range.start, 3)
        if split:
            break
    return split


def k9_chunks(torch, kb, x, idx_k1):
    """The three flagship chunks K9 is timed on, as (label, x, m, idx):
    uniform nodes, K1's nodes on a random codebook, and the main path's
    first chunk (``x``) under its initial codebook (the same RandomState
    draws as XPySom(random_seed=0)), where early training sends long runs
    of rows to a few nodes."""
    f = FLAGSHIP
    xy = f["x"] * f["y"]
    rng = np.random.RandomState(10)
    m = (rng.rand(f["chunk"]) > 0.05).astype(np.float32)
    w0 = np.random.RandomState(0).rand(f["x"], f["y"], f["d"]) * 2 - 1
    w0 = (w0 / np.linalg.norm(w0, axis=-1, keepdims=True)).reshape(-1, f["d"])
    cb0 = kb.PackedCodebook(torch.from_numpy(w0.astype(np.float32)).cuda())
    idx0, _ = kb.bmu_argmin(*cb0.operands(torch.from_numpy(x).cuda()))
    return [("uniform nodes", x, m, rng.randint(xy, size=f["chunk"])),
            ("K1's nodes", x, m, idx_k1),
            ("initial codebook's nodes", x, np.ones(f["chunk"], np.float32),
             idx0.cpu().numpy())]


def phase_stats(torch, card, x, idx_k1):
    """K9 bitwise against its plain version and a second launch on the
    three flagship chunks and on fixtures (ragged, every row on one node,
    D = 512 with its column passes, out-of-range int32 and int64 indices),
    then timed on each flagship chunk beside ``index_add_`` with a
    torch.profiler split of one call. Returns the record's timings (the
    initial codebook's chunk, the costliest), error and bound."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    f = FLAGSHIP
    xy = f["x"] * f["y"]
    cases = [(label, compare_stats(torch, ks, f"K9 flagship, {label}", xx, m, idx, xy))
             for label, xx, m, idx in k9_chunks(torch, kb, x, idx_k1)]
    rng = np.random.RandomState(11)
    m = (rng.rand(f["chunk"]) > 0.05).astype(np.float32)
    compare_stats(torch, ks, "K9 ragged", rng.rand(1000, 5).astype(np.float32),
                  (rng.rand(1000) > 0.2).astype(np.float32), rng.randint(91, size=1000), 91)
    compare_stats(torch, ks, "K9 every row on node 5", x, m, np.full(f["chunk"], 5), xy)
    compare_stats(torch, ks, "K9 D=512 (column passes)",
                  rng.rand(f["chunk"], 512).astype(np.float32), m,
                  rng.randint(xy, size=f["chunk"]), xy)
    bad = rng.randint(-xy, 2 * xy, size=f["chunk"])
    compare_stats(torch, ks, "K9 out-of-range int32 indices", x, m, bad, xy)
    bad64 = np.where(rng.rand(f["chunk"]) < 0.1, bad + (1 << 32), bad)
    compare_stats(torch, ks, "K9 out-of-range int64 indices", x, m, bad64, xy, torch.int64)

    # K9 reads x, mask and idx and writes the (XY, D+1) statistics: one
    # multiply and one add per element
    n, d = x.shape
    b = bound(2.0 * n * (d + 1) / FP32_INSTR, 4 * (n * d + 2 * n + xy * (d + 1)))
    timings = {}
    for label, (xs, ms9, is9, _) in cases:
        rows9 = torch.cat([xs * ms9[:, None], ms9[:, None]], dim=1)
        idx9 = is9.long()

        def library():
            return torch.zeros((xy, d + 1), device="cuda").index_add_(0, idx9, rows9)

        t = (cuda_ms(torch, lambda: ks.scatter_stats(xs, ms9, is9, xy)),
             cuda_ms(torch, lambda: ks.scatter_stats_plain(xs, ms9, is9, xy), reps=3, warmup=1),
             cuda_ms(torch, library))
        timings[label] = t
        split = _profile_split(torch, lambda: ks.scatter_stats(xs, ms9, is9, xy))
        lib_split = _profile_split(torch, library)
        print(f"time scatter_stats (K9) on the flagship chunk, {label}: kernel {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, library (index_add_) {t[2]:.4f} ms, bound {b[0]:.4f} ms "
              f"by {b[1]} (CUDA events; {card})")
        print(f"profile scatter_stats, {label}: device us by kernel {split} "
              f"(torch.profiler, one call; {card})")
        print(f"profile index_add_ (zeros + index_add_), {label}: device us by kernel "
              f"{lib_split} (torch.profiler, one call; {card})")
        print(f"device time of one call, {label}: K9 {sum(split.values()):.3f} us, "
              f"index_add_ {sum(lib_split.values()):.3f} us (torch.profiler; {card})")
    return timings["initial codebook's nodes"], 0.0, b


def phase_kernels(torch, card):
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

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

    timings = {
        "bmu_argmin": (cuda_ms(torch, lambda: kb.bmu_argmin(*ops)),
                       cuda_ms(torch, lambda: kb.bmu_argmin_plain(*ops)), None),
        "bmu_top2": (cuda_ms(torch, lambda: kb.bmu_top2(*ops)),
                     cuda_ms(torch, lambda: kb.bmu_top2_plain(*ops)), None),
    }
    for name, (ms, plain, _) in timings.items():
        print(f"time {name} at the flagship chunk: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events; {card})")
    # bounds at the flagship chunk: the augmented GEMM's 2·N·XY·K operations
    # on the tensor cores
    a, w_aug, xy = ops
    n, k = a.shape
    gemm = 2.0 * n * xy * k / BF16_FLOPS
    gemm_bytes = 2 * (n * k + k * w_aug.shape[1])
    bounds = {
        "bmu_argmin": bound(gemm, gemm_bytes + 8 * n),
        "bmu_top2": bound(gemm, gemm_bytes + 16 * n),
    }
    errs = {"bmu_argmin": err1, "bmu_top2": err2}
    # K9 on this chunk (K1's nodes among the three)
    timings["scatter_stats"], errs["scatter_stats"], bounds["scatter_stats"] = phase_stats(
        torch, card, x, idx)
    return timings, errs, bounds


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


def _lp64(x, w, p):
    """float64 sum_d |x_d - w_d|^p of the rows x (R, D) against w (R, D)."""
    return (np.abs(x.astype(np.float64) - w.astype(np.float64)) ** p).sum(-1)


def compare_tile(torch, name, kernel, plain, x, w, *args, exact, d64=None, band=None,
                 val_tol=None):
    """One register-tiled kernel against its plain version on (x, w).

    ``exact``: indices and values bitwise equal. Otherwise indices may
    differ only on rows where ``band(r, d)`` holds for the float64
    distances ``d = d64(r, cols)`` of the two candidates (a near-tie), and
    values agree within ``val_tol(r, v_plain)`` where the indices agree.
    Returns the max absolute value error and the operands."""
    xt = torch.from_numpy(x).cuda()
    wt = torch.from_numpy(w).cuda()
    extra = [torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a for a in args]
    i_k, v_k = kernel(xt, wt, *extra)
    i_p, v_p = plain(xt, wt, *extra)
    torch.cuda.synchronize()
    i_k, v_k, i_p, v_p = (u.cpu().numpy() for u in (i_k, v_k, i_p, v_p))
    n, xy = x.shape[0], w.shape[0]
    require(i_k.shape == (n,) and i_k.dtype == np.int32, f"{name}: output malformed")
    require(((i_k >= 0) & (i_k < xy)).all(), f"{name}: index out of range")
    require(not np.isnan(v_k).any(), f"{name}: NaN values")
    if exact:
        require(np.array_equal(i_k, i_p), f"{name}: {int((i_k != i_p).sum())} indices differ")
        require(np.array_equal(v_k.view(np.int32), v_p.view(np.int32)),
                f"{name}: values differ in bits")
        print(f"{name}: bitwise equal to the plain version ({n} rows, {xy} nodes)")
        return 0.0, (xt, wt, *extra)
    diff = np.nonzero(i_k != i_p)[0]
    bad = [r for r in diff if not band(r, d64(r, [i_k[r], i_p[r]]))]
    require(not bad, f"{name}: {len(bad)} of {len(diff)} index differences are not near-ties")
    same = np.nonzero(i_k == i_p)[0]
    err = np.abs(v_k[same].astype(np.float64) - v_p[same])
    tol = np.array([val_tol(r, v_p[r]) for r in same])
    require((err <= tol).all(), f"{name}: values disagree (max {err.max()})")
    print(f"{name}: {len(diff)} near-tie index differences of {n}, max|dv| {err.max():.3g}")
    return float(err.max()), (xt, wt, *extra)


def _k4_envelope(d):
    """K4's stated error per unit of sum_d |x_d||2 w_d| (csrc/highest.cu)."""
    from xpysom_dask_tpu_torch.ops.kernels.bmu import highest_envelope

    return highest_envelope(d)


def _tf32_rna_bits(v):
    """f32 ``v`` rounded to TF32 to nearest, ties away from zero, on the
    bits (ordinary finite values): add half of the 13 dropped bits to the
    magnitude, clear them."""
    return ((v.view(np.uint32).astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(
        np.uint32).view(np.float32)


def _check_split_tf32(torch, kb):
    """K4's split on the card (``cvt.rna.satfinite.tf32.f32``) against the
    rounding on the bits, bit for bit, for one 128 x 16 block of ordinary
    values (exact ties included); values within half a TF32 ulp of FLT_MAX
    split into finite halves."""
    from xpysom_dask_tpu_torch.ops.kernels import build

    rng = np.random.RandomState(5)
    v = (rng.randn(128, 16) * 10.0 ** rng.randint(-30, 31, (128, 16))).astype(np.float32)
    ties = v[:8].view(np.uint32)
    ties[:] = (ties & 0xFFFFE000) | 0x1000  # halfway between two TF32 values
    v[8, :4] = np.float32(np.finfo(np.float32).max) * np.array([1, -1, 1, -1], np.float32)
    v[8, 4:8] = np.nextafter(v[8, :4], 0)
    hi, lo = kb._split_tf32(build.load_library(), torch.from_numpy(v).cuda(),
                            torch.cuda.current_stream().cuda_stream)
    hi, lo = hi.view(512, 4).cpu().numpy(), lo.view(512, 4).cpu().numpy()
    # the search's block layout: float4 p holds row r[p], depth k[p] .. + 3
    p = np.arange(512)
    r, k = (p // 32) * 8 + p % 8, ((p // 8) % 4) * 4
    got_hi = np.stack([hi[:, j] for j in range(4)], 1)
    got_lo = np.stack([lo[:, j] for j in range(4)], 1)
    src = np.stack([v[r, k + j] for j in range(4)], 1)
    ordinary = np.ones(src.shape, bool)
    ordinary[r == 8] = ~np.isin(k[r == 8][:, None] + np.arange(4), np.arange(8))
    want_hi = _tf32_rna_bits(src)
    want_lo = _tf32_rna_bits(src - want_hi)
    require(np.array_equal(got_hi.view(np.uint32)[ordinary], want_hi.view(np.uint32)[ordinary])
            and np.array_equal(got_lo.view(np.uint32)[ordinary],
                               want_lo.view(np.uint32)[ordinary]),
            "K4 split: cvt.rna differs from the rounding on the bits")
    big = ~ordinary
    s64 = src[big].astype(np.float64)
    require(np.isfinite(got_hi[big]).all() and np.isfinite(got_lo[big]).all()
            and (np.abs(got_hi[big] + got_lo[big].astype(np.float64) - s64)
                 <= 2.0**-22 * np.abs(s64)).all(),
            f"K4 split near FLT_MAX: {got_hi[big]} {got_lo[big]}")
    print(f"K4 split: cvt.rna.satfinite.tf32.f32 equals the rounding on the bits "
          f"({int(ordinary.sum())} values, {ties.size} exact ties); values near FLT_MAX "
          f"split into finite halves within 2^-22")


def _dot_checks(x, w, w_sq):
    """K4's float64 distances and its near-tie band and value tolerance:
    K4's envelope plus cuBLAS's D * 2^-24, each times sum_d |x_d||2 w_d|,
    plus the rounding of the w_sq add; the band is twice that (two
    candidates)."""
    x64, w64, s64 = x.astype(np.float64), w.astype(np.float64), w_sq.astype(np.float64)
    mag = np.abs(x64) @ (2 * np.abs(w64)).max(0)
    d = x.shape[1]
    tol = (_k4_envelope(d) + d * F32_DOT) * mag + F32_DOT * np.abs(s64).max()

    def d64(r, cols):
        return -2.0 * w64[cols] @ x64[r] + s64[cols]

    def band(r, d):
        return abs(d[0] - d[1]) <= 2 * tol[r]

    return d64, band, lambda r, _: tol[r]


def _frac_checks(x, w, p):
    """K7's float64 distances, the JAX tests' relative near-tie margin and
    a relative value tolerance."""
    def d64(r, cols):
        return _lp64(x[r][None, :], w[cols], p)

    def band(r, d):
        return abs(d[0] - d[1]) <= FRAC_MARGIN * min(d)

    return d64, band, lambda r, v: FRAC_RTOL * abs(float(v))


def _compare_frac(torch, name, x, w, p):
    from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke

    return compare_tile(torch, name, ke.bmu_norm_p_frac, ke.bmu_norm_p_frac_plain, x, w, p,
                        exact=False, **dict(zip(("d64", "band", "val_tol"),
                                                _frac_checks(x, w, p))))


def phase_tile_kernels(torch, card):
    """K4-K7 against their plain versions; returns timings and errors."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke

    rng = np.random.RandomState(1)
    f = FLAGSHIP
    x = rng.rand(f["chunk"], f["d"]).astype(np.float32)
    w = rng.rand(f["x"] * f["y"], f["d"]).astype(np.float32)
    xr = rng.rand(1000, 5).astype(np.float32)
    wr = (rng.rand(7 * 13, 5) * 2 - 1).astype(np.float32)
    errs, ops = {}, {}

    # K4: the centered euclidean search (mode 'highest') and the even-p
    # expansion at p = 4 (D' = 320), as the main path packs them
    for label, (xx, ww) in (("flagship", (x, w)), ("ragged 1000x91 D=5", (xr, wr))):
        a, wc, wsq = kb.PackedCodebook(torch.from_numpy(ww), "highest").operands(
            torch.from_numpy(xx))
        a, wc, wsq = a.numpy(), wc.numpy(), wsq.numpy()
        err, o = compare_tile(torch, f"K4 {label}", kb.bmu_highest, kb.bmu_highest_plain,
                              a, wc, wsq, exact=False, **dict(zip(
                                  ("d64", "band", "val_tol"), _dot_checks(a, wc, wsq))))
        errs["bmu_highest"] = max(errs.get("bmu_highest", 0.0), err)
        ops.setdefault("bmu_highest", o)
    cb4 = kb.NormPEvenCodebook(torch.from_numpy(w), 4)
    phi, psi, z = (t.numpy() for t in cb4.operands(torch.from_numpy(x)))
    err, ops["bmu_highest D'=320"] = compare_tile(
        torch, "K4 norm_p p=4 expansion (16384x16384, D'=320)", kb.bmu_highest,
        kb.bmu_highest_plain, phi, psi, z, exact=False,
        **dict(zip(("d64", "band", "val_tol"), _dot_checks(phi, psi, z))))
    errs["bmu_highest"] = max(errs["bmu_highest"], err)
    # the expansion's winners are the float64 norm_p winners up to near-ties
    rows = 256
    i4, _ = kb.bmu_highest(*ops["bmu_highest D'=320"])
    i4 = i4[:rows].cpu().numpy()
    d4 = np.stack([_lp64(x[r][None, :], w, 4) for r in range(rows)])
    best = d4.min(1)
    require((d4[np.arange(rows), i4] - best <= 1e-4 * best).all(),
            "K4 p=4: a winner is not the float64 winner up to 1e-4")
    # tie fixture: duplicated codebook rows in tiles 0 and 23
    xt = np.zeros((4, 3), np.float32)
    xt[1] = 5
    wt = np.zeros((2100, 3), np.float32)
    wt[7] = wt[1500] = 5
    i, _ = kb.bmu_highest(torch.from_numpy(xt).cuda(), torch.from_numpy(wt).cuda(),
                          torch.from_numpy((wt * wt).sum(1)).cuda())
    require(i.cpu().tolist() == [0, 7, 0, 0], f"K4 tie fixture: {i.cpu().tolist()}")
    _check_split_tf32(torch, kb)

    # K5-K7 on the flagship chunk and the ragged shape
    cases = (
        ("bmu_manhattan", "K5", ke.bmu_manhattan, ke.bmu_manhattan_plain, (), None),
        ("bmu_norm_p_odd", "K6 p=3", ke.bmu_norm_p_odd, ke.bmu_norm_p_odd_plain, (3,), None),
        ("bmu_norm_p_frac", "K7 p=1.5", ke.bmu_norm_p_frac, ke.bmu_norm_p_frac_plain,
         (1.5,), 1.5),
        ("bmu_norm_p_frac", "K7 p=2.7", ke.bmu_norm_p_frac, ke.bmu_norm_p_frac_plain,
         (2.7,), 2.7),
    )
    for key, label, kern, plain, args, p in cases:
        for shape, (xx, ww) in (("flagship", (x, w)), ("ragged 1000x91 D=5", (xr, wr))):
            if p is None:
                err, o = compare_tile(torch, f"{label} {shape}", kern, plain, xx, ww, *args,
                                      exact=True)
            else:
                err, o = _compare_frac(torch, f"{label} {shape}", xx, ww, p)
            errs[key] = max(errs.get(key, 0.0), err)
            if shape == "flagship":
                ops[label] = (key, o[:2], args, kern, plain)
        # tie and zero-distance fixture: samples equal to codebook rows 7,
        # 10, 11, 12; row 7 duplicated at 9 (same tile) and 1500 (tile 23)
        wz = np.random.RandomState(2).rand(2100, 8).astype(np.float32)
        wz[9] = wz[1500] = wz[7]
        xz = wz[[7, 10, 11, 12]].copy()
        i, v = kern(torch.from_numpy(xz).cuda(), torch.from_numpy(wz).cuda(), *args)
        require(i.cpu().tolist() == [7, 10, 11, 12] and not v.cpu().numpy().any(),
                f"{label} tie/zero fixture: {i.cpu().tolist()} {v.cpu().tolist()}")
        # all-equal distances: index 0 wins
        i, v = kern(torch.zeros((5, 3)).cuda(), torch.ones((7, 3)).cuda(), *args)
        require(i.cpu().tolist() == [0] * 5 and (v.cpu().numpy() == 3.0).all(),
                f"{label} all-tie fixture: {i.cpu().tolist()}")
        print(f"{label}: tie, zero-distance and all-tie fixtures pass")

    # more counts of the one runtime multiply chain (term.reps in
    # tile_argmin.cuh): odd p with 0, 4 and 8 multiplies; fractional p
    # with 0, 3 and 4, through both branches (sqrt for 0.5 and 4.5)
    for p in (1, 5, 9):
        compare_tile(torch, f"K6 p={p} ragged", ke.bmu_norm_p_odd, ke.bmu_norm_p_odd_plain,
                     xr, wr, p, exact=True)
    for p in (0.5, 3.3, 4.5):
        _compare_frac(torch, f"K7 p={p} ragged", xr, wr, p)

    from xpysom_dask_tpu_torch.ops.distances import fp32_matmul

    def addmm_argmin(x_, w_, wsq_):
        with fp32_matmul():
            return torch.addmm(wsq_, x_, w_.T, alpha=-2).argmin(1)

    timings, bounds = {}, {}
    for label, key in (("K4 flagship", "bmu_highest"), ("K4 p=4 expansion D'=320", None)):
        o = ops[key or "bmu_highest D'=320"]
        t = (cuda_ms(torch, lambda: kb.bmu_highest(*o)),
             cuda_ms(torch, lambda: kb.bmu_highest_plain(*o)),
             cuda_ms(torch, lambda: addmm_argmin(*o)))
        n, d = o[0].shape
        xy = o[1].shape[0]
        nbytes = 4 * (n * d + xy * d + xy) + 8 * n
        # three TF32 passes on the tensor cores; one FP32 FFMA pass beside it
        b = bound(3 * 2.0 * n * xy * d / TF32_FLOPS, nbytes)
        b_ffma = bound(2.0 * n * xy * d / FP32_FLOPS, nbytes)
        if key:
            timings[key] = t
            bounds[key] = b
        print(f"time {label}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, library (addmm + "
              f"argmin) {t[2]:.4f} ms; bound {b[0]:.4f} ms (3 TF32 passes, by {b[1]}), FP32 "
              f"FFMA bound {b_ffma[0]:.4f} ms (CUDA events; {card})")
    for _, label, *_ in cases:
        key, (xt_, wt_), args, kern, plain = ops[label]
        p = args[0] if args else 1
        t = (cuda_ms(torch, lambda: kern(xt_, wt_, *args)),
             cuda_ms(torch, lambda: plain(xt_, wt_, *args), reps=3, warmup=1),
             cuda_ms(torch, lambda: torch.cdist(xt_, wt_, p=p).argmin(1), reps=3, warmup=1))
        # the record keeps K7's sqrt branch (p=1.5); the exp/log branch
        # (p=2.7) is printed
        if key not in timings:
            timings[key] = t
            bounds[key] = bound(_elementwise_seconds(p, xt_.shape[0], wt_.shape[0],
                                                     xt_.shape[1]),
                                4 * (xt_.numel() + wt_.numel()) + 8 * xt_.shape[0])
        print(f"time {label} flagship: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, library "
              f"(cdist p={p} + argmin) {t[2]:.4f} ms (CUDA events; {card})")
    return timings, errs, bounds


def _elementwise_seconds(p, n, xy, d):
    """Least issue time of the elementwise searches' n·xy·d terms: per
    term one subtract (|.| is an operand modifier) and one add, p − 1
    multiplies for odd p, ⌊p⌋ multiplies and one special-function result
    (sqrt) or two (exp, log) for fractional p; the FP32 and the
    special-function pipes run side by side, so the slower one bounds."""
    terms = float(n) * xy * d
    if float(p).is_integer():
        return terms * (1 + int(p)) / FP32_INSTR
    m = int(p)
    sfu = 1 if p - m == 0.5 else 2
    return max(terms * (2 + m) / FP32_INSTR, terms * sfu / SFU_RATE)


def _not_operand_ties(rows, a, w_aug, got, want):
    """The rows among ``rows`` whose two indices do not tie as two f32 sums
    of the same bf16 operands: the float64 values of A·W_aug at the two
    columns further apart than 2·K·2^-24·Σ_k |A_k||W_k|."""
    k = a.shape[1]
    bad = []
    for r in rows:
        cols = [int(got[r]), int(want[r])]
        ar = a[r].double().cpu().numpy()
        wc = w_aug[:, cols].double().cpu().numpy()
        d = ar @ wc
        if abs(d[0] - d[1]) > 2 * k * F32_U * (np.abs(ar) @ np.abs(wc)).max():
            bad.append(r)
    return bad


def _check_operand_ties(name, rows, a, w_aug, got, want):
    """Indices that differ between two f32 sums of the same bf16 operands
    must tie to within the f32 accumulation bound."""
    bad = _not_operand_ties(rows, a, w_aug, got, want)
    require(not bad, f"{name}: {len(bad)} of {len(rows)} index differences are not f32 ties")


def compare_mode(torch, kb, name, x, w, mode):
    """A precision mode's kernel against its plain version on (x, w),
    packed as the main path packs them: K3 under 'split3', K1 (and K2
    under 'bf16') under 'bf16' and 'split2'. K3's differing winners must
    be float64 near-ties of the data within the packed floor; K1/K2's,
    ties of the bf16 operands within the f32 accumulation bound. Values
    agree to VAL_RTOL of the row's term magnitudes. Returns the max value
    error and the operands."""
    xt = torch.from_numpy(x).cuda()
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda(), mode)
    ops = cb.operands(xt)
    center = cb.center.cpu().numpy()
    xc = (x - center).astype(np.float64)
    wc = (w - center).astype(np.float64)
    mag = np.abs(xc) @ np.abs(2 * wc).max(0) + (wc * wc).sum(1).max()
    tol = VAL_RTOL * (1.0 + mag)
    pairs = [(kb.bmu_split3, kb.bmu_split3_plain)] if mode == "split3" else \
        [(kb.bmu_argmin, kb.bmu_argmin_plain)]
    if mode == "bf16":
        pairs.append((kb.bmu_top2, kb.bmu_top2_plain))
    err = 0.0
    for kern, plain in pairs:
        got, want = kern(*ops), plain(*ops)
        torch.cuda.synchronize()
        got = [u.cpu().numpy() for u in got]
        want = [u.cpu().numpy() for u in want]
        i_k, v_k, i_p, v_p = got[0], got[1], want[0], want[1]
        require(i_k.shape == (x.shape[0],) and np.isfinite(v_k).all(),
                f"{name}: {kern.__name__} output malformed")
        require(((i_k >= 0) & (i_k < w.shape[0])).all(), f"{name}: index out of range")
        diff = np.nonzero(i_k != i_p)[0]
        if mode == "split3":
            _check_near_ties(f"{name} {kern.__name__}", diff, xc, wc, i_k, i_p)
        else:
            _check_operand_ties(f"{name} {kern.__name__}", diff, ops[0], ops[1], i_k, i_p)
        same = i_k == i_p
        if len(got) == 4:  # K2: the runner-up too
            diff2 = np.nonzero(got[2] != want[2])[0]
            _check_operand_ties(f"{name} K2 second", diff2, ops[0], ops[1], got[2], want[2])
            same2 = same & (got[2] == want[2])
            require((np.abs(got[3] - want[3]) <= tol)[same2].all(), f"{name}: K2 values")
        require((np.abs(v_k - v_p) <= tol)[same].all(), f"{name}: {kern.__name__} values")
        e = float(np.abs(v_k - v_p)[same].max()) if same.any() else 0.0
        err = max(err, e)
        print(f"{name}: {kern.__name__} {len(diff)} tie index differences of {len(i_k)}, "
              f"max|dv| {e:.3g}")
    return err, ops


def phase_mode_kernels(torch, card):
    """K3 and K1/K2 under the bf16 and split2 operands against their plain
    versions, and K8 bitwise against its plain version; returns K3's and
    K8's timings, errors and bounds."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import manhattan as km

    rng = np.random.RandomState(5)
    f = FLAGSHIP
    x = rng.rand(f["chunk"], f["d"]).astype(np.float32)
    w = rng.rand(f["x"] * f["y"], f["d"]).astype(np.float32)
    xr = rng.rand(1000, 5).astype(np.float32)
    wr = (rng.rand(7 * 13, 5) * 2 - 1).astype(np.float32)
    xt = np.zeros((4, 3), np.float32)
    xt[1] = 5
    wt = np.zeros((2100, 3), np.float32)
    wt[7] = wt[1500] = 5
    timings, errs, bounds, ops = {}, {}, {}, {}
    for mode in ("split3", "bf16", "split2"):
        e, ops[mode] = compare_mode(torch, kb, f"{mode} flagship", x, w, mode)
        e2, _ = compare_mode(torch, kb, f"{mode} ragged 1000x91 D=5", xr, wr, mode)
        errs[mode] = max(e, e2)
        cb = kb.PackedCodebook(torch.from_numpy(wt).cuda(), mode)
        i, _ = cb.argmin(torch.from_numpy(xt).cuda())
        require(i.cpu().tolist() == [0, 7, 0, 0], f"{mode} tie fixture: {i.cpu().tolist()}")
        print(f"{mode}: tie fixture (duplicates at 7 and 1500) keeps the first index")

    o3 = ops["split3"]
    timings["bmu_split3"] = (cuda_ms(torch, lambda: kb.bmu_split3(*o3)),
                             cuda_ms(torch, lambda: kb.bmu_split3_plain(*o3)), None)
    n, k = o3[0].shape
    xy = o3[5]
    bounds["bmu_split3"] = bound(3 * 2.0 * n * xy * k / BF16_FLOPS,
                                 2 * 2 * (n * k + k * o3[2].shape[1]) + 4 * xy + 8 * n)
    errs["bmu_split3"] = errs.pop("split3")
    print(f"time bmu_split3 (K3) at the flagship chunk: kernel {timings['bmu_split3'][0]:.4f} "
          f"ms, plain {timings['bmu_split3'][1]:.4f} ms (CUDA events; {card})")
    for mode in ("bf16", "split2"):
        a, w_aug, xy = ops[mode]
        t1 = (cuda_ms(torch, lambda: kb.bmu_argmin(a, w_aug, xy)),
              cuda_ms(torch, lambda: kb.bmu_argmin_plain(a, w_aug, xy)))
        b = bound(2.0 * a.shape[0] * xy * a.shape[1] / BF16_FLOPS, 0)[0]
        print(f"time bmu_argmin (K1) under {mode} operands (K={a.shape[1]}) at the flagship "
              f"chunk: kernel {t1[0]:.4f} ms, plain {t1[1]:.4f} ms, bound {b:.4f} ms "
              f"(CUDA events; {card})")
        if mode == "bf16":
            t2 = (cuda_ms(torch, lambda: kb.bmu_top2(a, w_aug, xy)),
                  cuda_ms(torch, lambda: kb.bmu_top2_plain(a, w_aug, xy)))
            print(f"time bmu_top2 (K2) under bf16 operands at the flagship chunk: kernel "
                  f"{t2[0]:.4f} ms, plain {t2[1]:.4f} ms (CUDA events; {card})")

    # K8: the L1 matrix, bit for bit
    for label, (xx, ww) in (("flagship", (x, w)), ("ragged 1000x91 D=5", (xr, wr))):
        xg, wg = torch.from_numpy(xx).cuda(), torch.from_numpy(ww).cuda()
        got = km.manhattan_distance(xg, wg)
        want = km.manhattan_distance_plain(xg, wg)
        torch.cuda.synchronize()
        require(got.shape == (len(xx), len(ww)), f"K8 {label}: shape {tuple(got.shape)}")
        require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                f"K8 {label}: {int((got != want).sum())} entries differ in bits")
        print(f"K8 {label}: bitwise equal to the plain version ({tuple(got.shape)})")
        del got, want
    xg, wg = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    timings["manhattan_distance"] = (
        cuda_ms(torch, lambda: km.manhattan_distance(xg, wg)),
        cuda_ms(torch, lambda: km.manhattan_distance_plain(xg, wg), reps=3, warmup=1),
        cuda_ms(torch, lambda: torch.cdist(xg, wg, p=1)),
    )
    n, d = xg.shape
    xy = wg.shape[0]
    bounds["manhattan_distance"] = bound(_elementwise_seconds(1, n, xy, d),
                                         4 * (n * d + xy * d + n * xy))
    errs["manhattan_distance"] = 0.0
    t = timings["manhattan_distance"]
    print(f"time manhattan_distance (K8) at the flagship chunk: kernel {t[0]:.4f} ms, plain "
          f"{t[1]:.4f} ms, library (cdist p=1) {t[2]:.4f} ms (CUDA events; {card})")
    return timings, {k: errs[k] for k in ("bmu_split3", "manhattan_distance")}, bounds


def _winner_flips(name, som, ref, data, d64, band):
    """Winners of ``som`` against ``ref`` (the plain versions) on ``data``:
    every differing row a float64 near-tie, ``|d64(x, w2)[0] -
    d64(x, w2)[1]| <= band(x, w2, d)`` for the two candidate rows ``w2``."""
    a, b = som.predict(data), ref.predict(data)
    w = som.get_weights().reshape(-1, data.shape[1]).astype(np.float64)
    diff = np.nonzero(a != b)[0]
    bad, worst = 0, 0.0
    for r in diff:
        x, w2 = data[r].astype(np.float64), w[[a[r], b[r]]]
        d = d64(x, w2)
        gap = abs(d[0] - d[1])
        bad += gap > band(x, w2, d)
        worst = max(worst, gap / max(abs(d[0]), abs(d[1])))
    require(not bad, f"{name}: {bad} of {len(diff)} winner differences are not near-ties "
            f"(largest relative float64 gap {worst:.3g})")
    print(f"{name}: winners agree with the plain versions on {len(data) - len(diff)} of "
          f"{len(data)}; the {len(diff)} others are near-ties (largest relative float64 "
          f"gap {worst:.3g})")


def phase_manhattan_path(torch):
    """The main path under activation_distance='manhattan' at full width."""
    from xpysom_dask_tpu_torch import XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    data = np.random.RandomState(3).rand(f["n"], f["d"]).astype(np.float32)
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0,
              activation_distance="manhattan")
    som = XPySom(f["x"], f["y"], f["d"], **kw)
    require(som._n_parallel == f["chunk"], f"chunk {som._n_parallel} != {f['chunk']}")

    kernels.reset_launch_counts()
    qe0 = som.quantization_error(data)
    for e in range(2):
        t0 = time.perf_counter()
        som.train(data, 10, iter_beg=e, iter_end=e + 1)
        print(f"manhattan path: epoch {e} of 10 in {time.perf_counter() - t0:.4f} s "
              "(host chunking and upload included)")
    win = som.predict(data[:4096])
    qe = som.quantization_error(data)
    te = som.topographic_error(data)
    counts = kernels.launch_counts()
    print(f"manhattan path: QE {qe0:.6f} -> {qe:.6f}, TE {te:.6f}; launch counts {counts}")

    w = som.get_weights()
    n_chunks = f["n"] // f["chunk"]
    require(w.shape == (f["x"], f["y"], f["d"]) and np.isfinite(w).all(),
            "manhattan codebook malformed")
    require(np.isfinite(qe) and qe < qe0, f"manhattan QE did not fall: {qe0} -> {qe}")
    require(0.0 <= te <= 1.0, f"manhattan TE {te} outside [0, 1]")
    require(counts["bmu_manhattan"] >= 2 * n_chunks + 1, "K5 launched too few times")
    require(counts["scatter_stats"] >= 2 * n_chunks, "K9 launched too few times")
    require(counts["bmu_argmin"] >= 2 * n_chunks, "K1 (QE) launched too few times")
    require(counts["bmu_top2"] >= 1, "K2 (TE) never launched")
    # K5 equals its plain version bit for bit, so the winners must too
    ref = XPySom.from_numpy(w, **kw, use_kernels=False)
    require(np.array_equal(win, ref.predict(data[:4096])),
            "manhattan winners differ from the plain versions'")
    print("manhattan path: winners equal the plain versions' on 4096 rows")

    _epoch_times(torch, "manhattan", som, data)
    return counts


def _epoch_times(torch, label, som, data):
    """Three epochs (3-5 of 10, after one unmeasured) of ``som``'s spec on
    device-resident chunks, each between two synchronizations; prints
    them and returns the median in seconds."""
    from xpysom_dask_tpu_torch import core

    chunks, mask, _ = som._chunked(data)
    step = core.make_epoch_step(som._spec, 10)
    ww = step(som._device_weights(), chunks, mask, 2)
    times = []
    for t in range(3, 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ww = step(ww, chunks, mask, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[1]
    print(f"{label} epoch on device-resident chunks (host clock, synchronized): "
          f"{[round(t * 1e3, 3) for t in times]} ms; median {med * 1e3:.3f} ms = "
          f"{len(data) / med / 1e6:.3f} M samples/s")
    return med


def phase_split3_and_hex_paths(torch, data):
    """The split3 path and the hexagonal path at full width on the
    flagship data: QE, 2 of 10 epochs, winner/QE/TE, the launch counters
    read around each path; split3's winners against the plain versions'.
    Then the epoch times of both beside the rectangular euclidean epoch.
    Returns each path's counts."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    n_chunks = f["n"] // f["chunk"]
    base = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    paths = {"rectangular": {}, "split3": dict(bmu_precision="split3"),
             "hexagonal": dict(topology="hexagonal")}
    soms, out = {}, {}
    for name, extra in paths.items():
        kw = dict(base, **extra)
        som = XPySom(f["x"], f["y"], f["d"], **kw)
        require(som._n_parallel == f["chunk"], f"{name}: chunk {som._n_parallel}")
        kernels.reset_launch_counts()
        qe0 = som.quantization_error(data)
        for e in range(2):
            t0 = time.perf_counter()
            som.train(data, 10, iter_beg=e, iter_end=e + 1)
            print(f"{name} path: epoch {e} of 10 in {time.perf_counter() - t0:.4f} s "
                  "(host chunking and upload included)")
        win = som.predict(data[:4096])
        qe = som.quantization_error(data)
        te = som.topographic_error(data)
        counts = kernels.launch_counts()
        print(f"{name} path: QE {qe0!r} -> {qe!r}, TE {te!r}; launch counts {counts}")
        w = som.get_weights()
        require(w.shape == (f["x"], f["y"], f["d"]) and np.isfinite(w).all(),
                f"{name}: codebook malformed")
        require(np.isfinite(qe) and qe < qe0, f"{name}: QE did not fall: {qe0} -> {qe}")
        require(np.isfinite(te) and 0.0 <= te <= 1.0, f"{name}: TE {te} outside [0, 1]")
        require(counts["scatter_stats"] >= 2 * n_chunks, f"{name}: K9 launched too few times")
        require(counts["bmu_top2"] >= 1, f"{name}: K2 (TE) never launched")
        if name == "split3":
            # 2 epochs, 2 QE and the winner probe, all through K3
            require(counts["bmu_split3"] >= 4 * n_chunks + 1, "K3 launched too few times")
            ref = XPySom.from_numpy(w, **kw, use_kernels=False)
            flat_p = ref.predict(data[:4096])
            w_flat = w.reshape(-1, f["d"]).astype(np.float64)
            center = w.reshape(-1, f["d"]).mean(0, dtype=np.float32).astype(np.float64)
            flips = np.nonzero(win != flat_p)[0]
            _check_near_ties("split3 winner", flips, data[:4096].astype(np.float64) - center,
                             w_flat - center, win, flat_p)
            print(f"split3 path: winners agree with the plain versions on "
                  f"{4096 - len(flips)} of 4096; the {len(flips)} others are near-ties")
        else:
            require(counts["bmu_argmin"] >= 4 * n_chunks, f"{name}: K1 launched too few times")
        soms[name] = (som, qe)
        out[name] = counts
    som_r, qe_r = soms["rectangular"]
    for name in ("split3", "hexagonal"):
        som, qe = soms[name]
        dw = np.abs(som.get_weights() - som_r.get_weights())
        print(f"{name} path against the rectangular packed path after the same 2 epochs: "
              f"QE {qe!r} vs {qe_r!r} (difference {qe - qe_r:.3e}), max|dw| {dw.max():.3e}, "
              f"mean|dw| {dw.mean():.3e}")
    for turn in ("rectangular", "split3", "hexagonal", "rectangular"):
        _epoch_times(torch, turn, soms[turn][0], data)
    return out


def phase_short_runs(torch):
    """One epoch on 2^16 samples under each other configuration: QE falls,
    the route's kernel launches, the winners agree with the plain
    versions' up to float64 near-ties."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    data = np.random.RandomState(4).rand(1 << 16, f["d"]).astype(np.float32)
    probe = data[:4096]

    d = f["d"]

    def cos64(x, w2):
        return 1 - (w2 @ x) / (np.linalg.norm(w2, axis=1) * np.linalg.norm(x))

    def cos_band(x, w2, _):
        # K1's packed floor on -x.w_hat (NEAR_TIE), in cosine units
        w_hat = w2 / np.linalg.norm(w2, axis=1, keepdims=True)
        return NEAR_TIE * (np.abs(w_hat) @ np.abs(x)).max() / np.linalg.norm(x)

    def lp(p):
        return lambda x, w2: _lp64(x[None, :], w2, p)

    def centered(x, w2, som):
        c = som.get_weights().reshape(-1, d).mean(0)
        return np.abs(x - c), np.abs(w2 - c)

    def highest_band(som):
        # twice K4's envelope plus cuBLAS's f32 bound on the centered
        # operands of -2 x.w + |w|^2
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            return 2 * (_k4_envelope(d) + d * F32_DOT) * (wc @ (2 * xc)).max()
        return band

    def expansion_band(som, p):
        # the same bound on the expansion's D(p+1) products:
        # sum_k |phi_k||psi_k| = sum_d (|x_d - c_d| + |w_d - c_d|)^p
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            dp = d * (p + 1)
            return 2 * (_k4_envelope(dp) + dp * F32_DOT) * ((xc + wc) ** p).sum(1).max()
        return band

    def bf16_band(som):
        # both sides search the same bf16 problem: a flip between them is
        # a float64 gap within twice its error envelope (the margin gate)
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            return MARGIN_GATE * (wc @ (2 * xc)).max()
        return band

    def packed_band(som):
        # margin's re-rank is packed K1: its floor on the centered operands
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            return NEAR_TIE * (wc @ (2 * xc)).max()
        return band

    configs = (
        ("cosine", dict(activation_distance="cosine"), "bmu_argmin", cos64,
         lambda som: cos_band),
        ("norm_p p=3", dict(activation_distance="norm_p", activation_distance_kwargs={"p": 3}),
         "bmu_norm_p_odd", lp(3), lambda som: lambda x, w2, d_: -1.0),  # bitwise: no flips
        ("norm_p p=1.5", dict(activation_distance="norm_p",
                              activation_distance_kwargs={"p": 1.5}), "bmu_norm_p_frac",
         lp(1.5), lambda som: lambda x, w2, d_: FRAC_MARGIN * min(d_)),
        ("norm_p p=4", dict(activation_distance="norm_p", activation_distance_kwargs={"p": 4}),
         "bmu_highest", lp(4), lambda som: expansion_band(som, 4)),
        ("euclidean highest", dict(bmu_precision="highest"), "bmu_highest",
         lambda x, w2: ((x - w2) ** 2).sum(1), highest_band),
        ("euclidean bf16", dict(bmu_precision="bf16"), "bmu_argmin",
         lambda x, w2: ((x - w2) ** 2).sum(1), bf16_band),
        ("euclidean split2", dict(bmu_precision="split2"), "bmu_argmin",
         lambda x, w2: ((x - w2) ** 2).sum(1), bf16_band),
        ("euclidean margin", dict(bmu_precision="margin"), "bmu_top2",
         lambda x, w2: ((x - w2) ** 2).sum(1), packed_band),
        ("cosine margin", dict(activation_distance="cosine", bmu_precision="margin"),
         "bmu_top2", cos64, lambda som: cos_band),
    )
    launches = {}
    for name, kw, kernel, d64, band in configs:
        kw = dict(kw, sigma=64, random_seed=0)
        som = XPySom(f["x"], f["y"], f["d"], **kw)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        qe0 = som.quantization_error(data)
        som.train(data, 1)
        qe = som.quantization_error(data)
        counts = kernels.launch_counts()
        print(f"{name}: QE {qe0:.6f} -> {qe:.6f} in {time.perf_counter() - t0:.3f} s; "
              f"launches {counts}")
        require(np.isfinite(qe) and qe < qe0, f"{name}: QE did not fall: {qe0} -> {qe}")
        require(counts[kernel] >= (1 << 16) // f["chunk"], f"{name}: {kernel} not launched")
        require(counts["scatter_stats"] >= 1, f"{name}: K9 not launched")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        ref = XPySom.from_numpy(som.get_weights(), **kw, use_kernels=False)
        _winner_flips(name, som, ref, probe, d64, band(som))
        mode = kw.get("bmu_precision")
        if mode in ("bf16", "split2", "margin"):
            _exact_flips(torch, name, som, probe, d64, band(som), must=mode == "margin")
        if mode == "margin":
            _margin_share(torch, name, som, data)
        _bmu_time(torch, name, som, data)
    return launches


def _exact_flips(torch, name, som, probe, d64, band, must):
    """Winners against the float64 argmin of the activation on the probe;
    with ``must``, every difference has to be a near-tie within ``band``
    (margin's contract: exact up to the packed re-rank's floor)."""
    win = som.predict(probe)
    w = som.get_weights().reshape(-1, probe.shape[1]).astype(np.float64)
    wt = torch.from_numpy(w).cuda()
    best = []
    for s in range(0, len(probe), 512):
        xb = torch.from_numpy(probe[s:s + 512].astype(np.float64)).cuda()
        if som._activation_distance_name == "cosine":
            d = 1 - (xb @ wt.T) / (xb.norm(dim=1, keepdim=True) * wt.norm(dim=1)[None, :])
        else:
            d = (xb * xb).sum(1, keepdim=True) - 2 * xb @ wt.T + (wt * wt).sum(1)[None, :]
        best.append(d.argmin(1).cpu().numpy())
    best = np.concatenate(best)
    diff = np.nonzero(win != best)[0]
    bad = 0
    for r in diff:
        x, w2 = probe[r].astype(np.float64), w[[win[r], best[r]]]
        dd = d64(x, w2)
        bad += abs(dd[0] - dd[1]) > band(x, w2, dd)
    print(f"{name}: winners equal the float64 argmin on {len(probe) - len(diff)} of "
          f"{len(probe)}; {len(diff)} differ, {len(diff) - bad} of them near-ties")
    if must:
        require(not bad, f"{name}: {bad} winners differ from the float64 argmin beyond the "
                "packed floor")


def _margin_share(torch, name, som, data):
    """The share of each chunk's rows that margin's gate sends to the
    re-rank, on the trained codebook."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

    w = torch.from_numpy(som.get_weights().reshape(-1, data.shape[1]).astype(np.float32)).cuda()
    if som._activation_distance_name == "cosine":
        cb = kb.cosine_codebook(w, "margin")
    else:
        cb = kb.PackedCodebook(w, "margin")
    shares = []
    for s in range(0, len(data), FLAGSHIP["chunk"]):
        x = torch.from_numpy(data[s:s + FLAGSHIP["chunk"]]).cuda()
        _, val, _, val2 = kb.bmu_top2(*cb.operands(x))
        xc = x if cb.center is None else x - cb.center[None, :]
        shares.append(float(kb.margin_suspects(val, val2, xc, cb.w).float().mean()))
    cap = 0.125
    print(f"{name}: rescued share per chunk {[round(v, 5) for v in shares]} "
          f"(capacity {cap}; above it a chunk takes the full packed pass)")


def _bmu_time(torch, name, som, data):
    """``make_bmu_fn`` over the data on device-resident chunks, median of
    three synchronized host-clock runs."""
    from xpysom_dask_tpu_torch import core

    chunks, _, _ = som._chunked(data)
    fn = core.make_bmu_fn(som._spec)
    w = som._device_weights()
    fn(w, chunks)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(w, chunks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"{name}: BMU search over {len(data)} samples {sorted(times)[1] * 1e3:.3f} ms "
          "(device-resident chunks, median of 3)")


def phase_margin_compact(torch, card):
    """Mode 'margin' where its gate leaves most rows alone: one flagship
    chunk of clustered data (after tests/test_margin_bmu.py:45), whose
    suspects fit the rescue buffer, so the compacted re-rank runs on the
    card. The branch is asserted (one K1 launch over the buffer's rows);
    the winners are held against use_kernels=False and the float64 argmin
    (differences only inside the packed floor), and through the model's
    ``predict``. The search is timed by CUDA events beside K2 (bf16) and
    the packed K1 over all rows and over the buffer, and the host read of
    the suspect count is timed apart."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

    f = FLAGSHIP
    xy, d, n = f["x"] * f["y"], f["d"], f["chunk"]
    rng = np.random.RandomState(7)
    # XY/64 clusters of 4 codebook rows (spread 2e-2) among spread rows;
    # 6% of the samples fall among a cluster's rows (margins ~1e-2, far
    # inside the bf16 gate of ~0.4 and far outside the packed floor of
    # ~1e-4), the others on a spread row (margins of several units)
    nc = xy // 64
    w0 = rng.rand(xy, d)
    base = rng.rand(nc, d)
    w0[:4 * nc] = np.repeat(base, 4, axis=0) + 2e-2 * rng.randn(4 * nc, d)
    x = w0[rng.randint(4 * nc, xy, size=n)] + 1e-2 * rng.randn(n, d)
    near = rng.rand(n) < 0.06
    x[near] = base[rng.randint(nc, size=int(near.sum()))] + 2e-2 * rng.randn(int(near.sum()), d)
    w = w0[rng.permutation(xy)].astype(np.float32)  # the clusters span every tile
    x = x.astype(np.float32)

    xt = torch.from_numpy(x).cuda()
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda(), "margin")
    ops = cb.operands(xt)
    xc = xt - cb.center[None, :]
    i_b, v_b, _, v2_b = kb.bmu_top2(*ops)
    suspect = kb.margin_suspects(v_b, v2_b, xc, cb.w)
    n_sus = int(suspect.sum())
    cap = min(n, max(8, -(-int(n * kb.RESCUE_FRAC) // 8) * 8))
    sizes = []

    def k1(a, w_aug, xy_):
        sizes.append(a.shape[0])
        return kb.bmu_argmin(a, w_aug, xy_)

    i_r, v_r = kb.margin_rescue(i_b, v_b, v2_b, xc, cb.w, cb.w_sq, cb.w_aug_packed, k1)
    require(0 < n_sus <= cap, f"margin compact: {n_sus} suspects against capacity {cap}")
    require(sizes == [cap], f"margin compact: K1 ran over {sizes} rows, not the buffer's {cap}")
    i_k, v_k = cb.argmin(xt)
    i_p, _ = cb.argmin(xt, use_kernels=False)
    torch.cuda.synchronize()
    require(torch.equal(i_k, i_r) and torch.equal(v_k, v_r),
            "margin compact: the search differs from its own rescue")

    # the float64 argmin of the centered operands, in row blocks on the card
    center = cb.center.double()
    xc64 = xt.double() - center
    wc64 = torch.from_numpy(w).cuda().double() - center
    wsq64 = (wc64 * wc64).sum(1)
    best = torch.cat([(wsq64[None, :] - 2 * xc64[s:s + 2048] @ wc64.T).argmin(1)
                      for s in range(0, n, 2048)]).cpu().numpy()
    got, plain, raw = (t.cpu().numpy() for t in (i_k, i_p, i_b))
    xc_np, wc_np = xc64.cpu().numpy(), wc64.cpu().numpy()
    for label, other in (("use_kernels=False", plain), ("the float64 argmin", best)):
        diff = np.nonzero(got != other)[0]
        _check_near_ties(f"margin compact vs {label}", diff, xc_np, wc_np, got, other)
        print(f"margin compact: winners equal {label} on {n - len(diff)} of {n}; the "
              f"{len(diff)} others are near-ties inside the packed floor")
    print(f"margin compact: {n_sus} suspects of {n} ({n_sus / n:.4f}) in a buffer of {cap}; "
          f"the bf16 pass alone differs from the float64 argmin on "
          f"{int((raw != best).sum())} rows, the rescue on {int((got != best).sum())}")

    # through the model's entry point
    som = XPySom.from_numpy(w.reshape(f["x"], f["y"], d), sigma=64, random_seed=0,
                            bmu_precision="margin")
    kernels.reset_launch_counts()
    win = som.predict(x)
    counts = kernels.launch_counts()
    require(np.array_equal(win, got), "margin compact: predict differs from the search")
    require(counts["bmu_top2"] >= 1 and counts["bmu_argmin"] >= 1,
            f"margin compact: predict launched {counts}")

    # times at this chunk (CUDA events; the full search's include its host
    # read and the idle device around it)
    packed = kb.PackedCodebook(torch.from_numpy(w).cuda())
    a_p, w_aug_p, _ = packed.operands(xt)
    a_buf = a_p[:cap].contiguous()
    t = {
        "margin search": cuda_ms(torch, lambda: cb.argmin(xt)),
        "its operands (centering, bf16 packing)": cuda_ms(torch, lambda: cb.operands(xt)),
        "K2 on bf16 operands": cuda_ms(torch, lambda: kb.bmu_top2(*ops)),
        "the rescue after K2 (gate, host read, compaction, packing, K1 over the buffer, "
        "scatter, exact values)": cuda_ms(torch, lambda: kb.margin_rescue(
            i_b, v_b, v2_b, xc, cb.w, cb.w_sq, cb.w_aug_packed, kb.bmu_argmin)),
        "gate": cuda_ms(torch, lambda: kb.margin_suspects(v_b, v2_b, xc, cb.w)),
        f"packed K1 over the {cap}-row buffer": cuda_ms(
            torch, lambda: kb.bmu_argmin(a_buf, w_aug_p, xy)),
        f"packed K1 over all {n} rows": cuda_ms(torch, lambda: kb.bmu_argmin(a_p, w_aug_p, xy)),
    }
    for label, ms in t.items():
        print(f"time {label} at the flagship chunk: {ms:.4f} ms (CUDA events; {card})")
    reads = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(torch.count_nonzero(suspect))
        reads.append(time.perf_counter() - t0)
    print(f"time host read of the suspect count (count_nonzero + copy to the host, idle "
          f"queue): median {sorted(reads)[25] * 1e3:.4f} ms, mean {np.mean(reads) * 1e3:.4f} ms "
          f"of 50 (host clock; {card})")


def phase_activate(torch, card):
    """``activate`` under manhattan on 8192 samples x 16384 nodes: K8
    launches, and the matrix equals the plain versions' (use_kernels=False
    on the card) bit for bit. Returns the counts."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    data = np.random.RandomState(6).rand(8192, f["d"]).astype(np.float32)
    kw = dict(sigma=64, random_seed=0, activation_distance="manhattan")
    som = XPySom(f["x"], f["y"], f["d"], **kw)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = som.activate(data)
    took = time.perf_counter() - t0
    counts = kernels.launch_counts()
    require(counts["manhattan_distance"] >= 1, "activate: K8 never launched")
    require(got.shape == (8192, f["x"] * f["y"]) and np.isfinite(got).all(),
            f"activate: malformed {got.shape}")
    t0 = time.perf_counter()
    want = XPySom(f["x"], f["y"], f["d"], **kw, use_kernels=False).activate(data)
    took_plain = time.perf_counter() - t0
    require(np.array_equal(got.view(np.int32), want.view(np.int32)),
            "activate: K8's matrix differs from the plain versions' in bits")
    print(f"activate (manhattan, 8192 x 16384): bitwise equal to use_kernels=False; "
          f"{took:.3f} s with K8 ({counts['manhattan_distance']} launches), "
          f"{took_plain:.3f} s plain (host clock, host copies included)")
    # K8 at the shape activate launches it with: one chunk of _matrix_chunk
    # rows against the whole codebook
    from xpysom_dask_tpu_torch.ops.kernels import manhattan as km

    rows = som._matrix_chunk
    xg = torch.from_numpy(data[:rows]).cuda()
    wg = som._device_weights().reshape(-1, f["d"]).contiguous()
    ms = cuda_ms(torch, lambda: km.manhattan_distance(xg, wg))
    xy = wg.shape[0]
    b_ms, b_by = bound(_elementwise_seconds(1, rows, xy, f["d"]),
                       4 * (rows * f["d"] + xy * f["d"] + rows * xy))
    print(f"time manhattan_distance (K8) at activate's chunk ({rows} x {xy}, "
          f"{-(-rows // 64)} blocks of 64 rows): {ms:.4f} ms per launch "
          f"(bound {b_ms:.4f} ms by {b_by}), "
          f"{ms * counts['manhattan_distance']:.3f} ms for activate's "
          f"{counts['manhattan_distance']} launches (CUDA events; {card})")
    return counts


def _kb_flips(name, rows, mode, xc, wc, a, w_aug, got, want):
    """Winners that differ between two sums of the same operands must tie
    as f32 sums of those operands or, under packed, be float64 near-ties
    of the centered data within the packed floor."""
    bad = _not_operand_ties(rows, a, w_aug, got, want)
    if mode == "packed":
        _check_near_ties(name, bad, xc, wc, got, want)
    else:
        require(not bad, f"{name}: {len(bad)} of {len(rows)} index differences are not ties")


def phase_kblock(torch, card):
    """The wide-D search through ``PackedCodebook.argmin(kblock=)`` at the
    shapes of tools/r4_kblock.py, modes packed and bf16, kblock 512 and
    1024 (the counters read around those calls); then K1-kb against its
    plain version and K1 on the same operands, a ragged shape, a tie
    fixture across slabs, the validation errors, and CUDA-event timings.
    Returns the launches, the max value error, the record's timings and
    bound (packed, 16384 x 16384 x 512, kblock 512)."""
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

    rng = np.random.RandomState(8)
    data = {s: (rng.rand(s[0], s[2]).astype(np.float32), rng.rand(s[1], s[2]).astype(np.float32))
            for s in WIDE_SHAPES}
    cases = [(s, mode, kbk) for s in WIDE_SHAPES for mode in ("packed", "bf16")
             for kbk in (512, 1024)]
    dev = {s: (torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda())
           for s, (x, w) in data.items()}
    cbs = {(s, mode): kb.PackedCodebook(dev[s][1], mode) for s in WIDE_SHAPES
           for mode in ("packed", "bf16")}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = {c: cbs[c[:2]].argmin(dev[c[0]][0], kblock=c[2]) for c in cases}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"wide-D path launch counts: {counts}")
    require(counts["bmu_argmin_kb"] == len(cases), "K1-kb not launched on every call")
    require(counts["bmu_argmin"] == 0, "the kblock search fell back to K1")

    err, record = 0.0, None
    for (shape, mode, kbk) in cases:
        n, xy, d = shape
        x, w = data[shape]
        cb = cbs[(shape, mode)]
        ops = cb.operands(dev[shape][0])
        a, w_aug, _ = ops
        i_k, v_k = out[(shape, mode, kbk)]
        i_p, v_p = kb.bmu_argmin_kb_plain(*ops, kbk)
        i_1, v_1 = kb.bmu_argmin(*ops)
        torch.cuda.synchronize()
        i_k, v_k, i_p, v_p, i_1 = (u.cpu().numpy() for u in (i_k, v_k, i_p, v_p, i_1))
        require(i_k.shape == (n,) and np.isfinite(v_k).all(), f"K1-kb {shape}: malformed")
        require(((i_k >= 0) & (i_k < xy)).all(), f"K1-kb {shape}: index out of range")
        center = cb.center.cpu().numpy()
        xc = (x - center).astype(np.float64)
        wc = (w - center).astype(np.float64)
        name = f"K1-kb {mode} kblock={kbk} {n}x{xy} D={d}"
        for label, other in (("plain", i_p), ("K1", i_1)):
            diff = np.nonzero(i_k != other)[0]
            _kb_flips(f"{name} vs {label}", diff, mode, xc, wc, a, w_aug, i_k, other)
            print(f"{name}: {len(diff)} tie index differences of {n} against {label}")
        mag = np.abs(xc) @ np.abs(2 * wc).max(0) + (wc * wc).sum(1).max()
        same = i_k == i_p
        require((np.abs(v_k - v_p) <= VAL_RTOL * (1.0 + mag))[same].all(),
                f"{name}: values disagree with the plain version")
        e = float(np.abs(v_k - v_p)[same].max())
        err = max(err, e)
        t = (cuda_ms(torch, lambda: kb.bmu_argmin_kb(*ops, kbk)),
             cuda_ms(torch, lambda: kb.bmu_argmin(*ops)),
             cuda_ms(torch, lambda: kb.bmu_argmin_kb_plain(*ops, kbk), reps=3, warmup=1))
        k = a.shape[1]
        b = bound(2.0 * n * xy * k / BF16_FLOPS, 2 * (n * k + k * w_aug.shape[1]) + 8 * n)
        print(f"time {name} (K = {k}, padded to {-(-k // kbk) * kbk}): K1-kb {t[0]:.4f} ms, "
              f"K1 {t[1]:.4f} ms, plain {t[2]:.4f} ms, bound {b[0]:.4f} ms by {b[1]}; "
              f"max|dv| {e:.3g} (CUDA events; {card})")
        if record is None:
            record = ((t[0], t[2], None), b)
        del i_p, v_p

    # ragged: K = 3·200 + 3 = 603 in five 128-deep slabs, 91 nodes
    xr = rng.rand(1000, 200).astype(np.float32)
    wr = (rng.rand(91, 200) * 2 - 1).astype(np.float32)
    for mode in ("packed", "bf16"):
        cb = kb.PackedCodebook(torch.from_numpy(wr).cuda(), mode)
        ops = cb.operands(torch.from_numpy(xr).cuda())
        i_k, v_k = cb.argmin(torch.from_numpy(xr).cuda(), kblock=128)
        i_p, v_p = kb.bmu_argmin_kb_plain(*ops, 128)
        diff = np.nonzero((i_k != i_p).cpu().numpy())[0]
        center = cb.center.cpu().numpy()
        _kb_flips(f"K1-kb {mode} ragged", diff, mode, (xr - center).astype(np.float64),
                  (wr - center).astype(np.float64), ops[0], ops[1], i_k.cpu().numpy(),
                  i_p.cpu().numpy())
        e = float((v_k - v_p).abs()[i_k == i_p].max())
        err = max(err, e)
        print(f"K1-kb {mode} ragged 1000x91 D=200 kblock=128: {len(diff)} tie differences, "
              f"max|dv| {e:.3g}")
    # tie fixture across slabs: duplicated codebook rows 7 and 1500 whose
    # distance to sample 1 sums features 0 (slab 0) and 299 (slab 2 of
    # 128-deep slabs)
    xt = np.zeros((4, 300), np.float32)
    xt[1, [0, 299]] = 5
    wt = np.zeros((2100, 300), np.float32)
    wt[[7, 1500]] = xt[1]
    for mode in ("packed", "bf16"):
        i, _ = kb.PackedCodebook(torch.from_numpy(wt).cuda(), mode).argmin(
            torch.from_numpy(xt).cuda(), kblock=128)
        require(i.cpu().tolist() == [0, 7, 0, 0], f"K1-kb {mode} tie fixture: {i.cpu().tolist()}")
    print("K1-kb: tie fixture across slabs keeps the first index (packed, bf16)")
    # the JAX package's refusals, in its words
    cb = kb.PackedCodebook(dev[WIDE_SHAPES[0]][1][:64], "highest")
    for fn, pattern in ((lambda: cb.argmin(dev[WIDE_SHAPES[0]][0][:8], kblock=128),
                         "kblock.*requires mode"),
                        (lambda: cbs[(WIDE_SHAPES[0], "packed")].argmin(
                            dev[WIDE_SHAPES[0]][0][:8], kblock=100), "multiple of 128"),
                        (lambda: cbs[(WIDE_SHAPES[0], "packed")].top2(
                            dev[WIDE_SHAPES[0]][0][:8], kblock=128), "top2")):
        try:
            fn()
        except ValueError as exc:
            require(re.search(pattern, str(exc)), f"K1-kb validation: {exc}")
        else:
            raise RuntimeError(f"K1-kb validation: no error for {pattern!r}")
    print("K1-kb: the three validation errors match the JAX package's")
    del out, dev, cbs
    torch.cuda.empty_cache()
    return counts["bmu_argmin_kb"], err, record[0], record[1]


def _fused_vs_k1_k9(torch, name, x, w, m):
    """K10 on one chunk against K1 + K9 on the same uncentered packed
    operands (winners and statistics bitwise) and against itself; returns
    the operands."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import fused_stats as kf
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    cb = kb.PackedCodebook(w, "packed", center=False)
    i_f, acc = kf.bmu_stats_fused(x, cb, m)
    i_f2, acc2 = kf.bmu_stats_fused(x, cb, m)
    i_1, _ = kb.bmu_argmin(*cb.operands(x))
    acc9 = ks.scatter_stats(x, m, i_1, cb.xy)
    torch.cuda.synchronize()
    require(torch.equal(i_f, i_1), f"{name}: K10 winners differ from K1's")
    require(torch.equal(acc.view(torch.int32), acc9.view(torch.int32)),
            f"{name}: K10 statistics differ from K9's in bits")
    require(torch.equal(i_f2, i_f) and torch.equal(acc2.view(torch.int32), acc.view(torch.int32)),
            f"{name}: two K10 launches differ")
    require(float(acc[:, -1].sum()) == float(m.sum()), f"{name}: K10 counts lost rows")
    run = int(torch.bincount(i_f.long()).max())
    print(f"{name}: K10 winners equal K1's, statistics equal K9's bit for bit, two launches "
          f"equal; longest run {run} rows")
    return cb, run


def phase_fused_epoch(torch, card):
    """Two flagship epochs whose statistics come from K10 (the counters
    read around them), bitwise against the same epochs from K1 + K9 and a
    second run; K10 against K1 + K9 on a uniform, a ragged and the skewed
    first chunk, with per-chunk and per-epoch times. Returns the launches,
    the error, the record's timings and bound."""
    from xpysom_dask_tpu_torch import XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import fused_stats as kf
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    f = FLAGSHIP
    d, xy = f["d"], f["x"] * f["y"]
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    som = XPySom(f["x"], f["y"], d, **kw)
    spec = som._spec
    data = np.random.RandomState(0).rand(f["n"], d).astype(np.float32)
    chunks, mask, _ = core.chunk_data(data, f["chunk"])
    chunks, mask = torch.from_numpy(chunks).cuda(), torch.from_numpy(mask).cuda()
    w0 = som._device_weights().reshape(xy, d).contiguous()

    def epochs(fused, w):
        ws = []
        for t in range(2):
            eta, sig = core._decays(spec, t, 10, w.device)
            s, cnt = kf.epoch_stats(w, chunks, mask, fused=fused)
            w = core._update_from_stats(spec, w, s, cnt, eta, sig)
            ws.append(w)
        return ws

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fused = epochs(True, w0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"fused-stats path launch counts: {counts}")
    n_chunks = chunks.shape[0]
    require(counts["bmu_stats_fused"] == 2 * n_chunks, "K10 not launched on every chunk")
    require(counts["bmu_argmin"] == 0 and counts["scatter_stats"] == 0,
            "the fused path launched K1 or K9")
    again = epochs(True, w0)
    split = epochs(False, w0)
    torch.cuda.synchronize()
    for t in range(2):
        require(torch.isfinite(fused[t]).all(), f"fused epoch {t}: codebook not finite")
        require(torch.equal(fused[t].view(torch.int32), again[t].view(torch.int32)),
                f"fused epoch {t}: a second run changed the codebook bits")
        require(torch.equal(fused[t].view(torch.int32), split[t].view(torch.int32)),
                f"fused epoch {t}: codebook differs from the K1 + K9 epoch in bits")
    qe = [float(core.make_quantization_stats_fn(spec)(w.reshape(f["x"], f["y"], d), chunks,
                                                      mask)[0]) / f["n"]
          for w in (w0, fused[1])]
    require(qe[1] < qe[0], f"fused epochs: QE did not fall {qe}")
    print(f"fused-stats path: 2 epochs bitwise equal to the K1 + K9 epochs and to a second "
          f"run; QE {qe[0]!r} -> {qe[1]!r}")

    # per chunk: uniform, ragged, and the first chunk under the initial
    # codebook (early training's skew)
    rng = np.random.RandomState(9)
    xu = torch.from_numpy(rng.rand(f["chunk"], d).astype(np.float32)).cuda()
    wu = torch.from_numpy(rng.rand(xy, d).astype(np.float32)).cuda()
    mu = torch.from_numpy((rng.rand(f["chunk"]) > 0.05).astype(np.float32)).cuda()
    cb_u, _ = _fused_vs_k1_k9(torch, "K10 flagship chunk, uniform codebook", xu, wu, mu)
    _fused_vs_k1_k9(torch, "K10 ragged 1000x91 D=5",
                    torch.from_numpy(rng.rand(1000, 5).astype(np.float32)).cuda(),
                    torch.from_numpy((rng.rand(91, 5) * 2 - 1).astype(np.float32)).cuda(),
                    torch.from_numpy((rng.rand(1000) > 0.2).astype(np.float32)).cuda())
    cb_s, run = _fused_vs_k1_k9(torch, "K10 skewed chunk (first chunk, initial codebook)",
                                chunks[0], w0, mask[0])

    # against the plain version on the card: winners up to near-ties of the
    # uncentered packed operands, statistics K9's plain ones on K10's winners
    i_f, acc = kf.bmu_stats_fused(xu, cb_u, mu)
    i_p, _ = kf.bmu_stats_fused_plain(xu, cb_u, mu)
    torch.cuda.synchronize()
    diff = np.nonzero((i_f != i_p).cpu().numpy())[0]
    a_u, w_aug_u, _ = cb_u.operands(xu)
    _check_operand_ties("K10 vs plain", diff, a_u, w_aug_u, i_f.cpu().numpy(), i_p.cpu().numpy())
    require(torch.equal(acc.view(torch.int32),
                        ks.scatter_stats_plain(xu, mu, i_f, xy).view(torch.int32)),
            "K10 statistics differ from the plain scatter on its winners")
    print(f"K10 vs plain: {len(diff)} tie winner differences of {f['chunk']}; statistics "
          "equal the plain scatter's on K10's winners bit for bit")

    def k1_k9(cb, x, m):
        i, _ = kb.bmu_argmin(*cb.operands(x))
        return ks.scatter_stats(x, m, i, xy)

    timings = {}
    for label, (cb, x, m) in (("uniform", (cb_u, xu, mu)),
                              (f"skewed (longest run {run})", (cb_s, chunks[0], mask[0]))):
        i, _ = kb.bmu_argmin(*cb.operands(x))
        t = (cuda_ms(torch, lambda: kf.bmu_stats_fused(x, cb, m)),
             cuda_ms(torch, lambda: kf.bmu_stats_fused_plain(x, cb, m), reps=3, warmup=1),
             cuda_ms(torch, lambda: k1_k9(cb, x, m)),
             cuda_ms(torch, lambda: kb.bmu_argmin(*cb.operands(x))),
             cuda_ms(torch, lambda: ks.scatter_stats(x, m, i, xy)))
        timings[label] = t
        print(f"time K10 {label} chunk (each with the samples' packing): fused {t[0]:.4f} ms, "
              f"plain {t[1]:.4f} ms, K1 + K9 {t[2]:.4f} ms, of which K1 {t[3]:.4f} ms and K9 "
              f"{t[4]:.4f} ms (CUDA events; {card})")
    for fused_flag in (True, False, True, False):
        ms = cuda_ms(torch, lambda: kf.epoch_stats(w0, chunks, mask, fused=fused_flag), reps=3,
                     warmup=1)
        print(f"time epoch statistics under the initial codebook ({n_chunks} chunks): "
              f"{'K10' if fused_flag else 'K1 + K9'} {ms:.3f} ms (CUDA events; {card})")
    ms = cuda_ms(torch, lambda: kf.epoch_stats(fused[0], chunks, mask), reps=3, warmup=1)
    ms9 = cuda_ms(torch, lambda: kf.epoch_stats(fused[0], chunks, mask, fused=False), reps=3,
                  warmup=1)
    print(f"time epoch statistics under the codebook after one epoch: K10 {ms:.3f} ms, "
          f"K1 + K9 {ms9:.3f} ms (CUDA events; {card})")

    n, k = a_u.shape
    nbytes = 2 * (n * k + k * w_aug_u.shape[1]) + 4 * (n * d + 2 * n + xy * (d + 1))
    t = timings["uniform"]
    return counts["bmu_stats_fused"], 0.0, (t[0], t[1], None), \
        bound(2.0 * n * xy * k / BF16_FLOPS, nbytes)


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
    timings, errs, bounds = phase_kernels(torch, smi)
    for phase in (phase_tile_kernels, phase_mode_kernels):
        t2, e2, b2 = phase(torch, smi)
        timings.update(t2)
        errs.update(e2)
        bounds.update(b2)
    data, kw, w3, counts = phase_main_path(torch)
    phase_determinism(torch, data, kw, w3)
    counts_paths = phase_split3_and_hex_paths(torch, data)
    del data
    counts_l1 = phase_manhattan_path(torch)
    # each kernel's launches on the path that runs it, its counters set
    # to 0 just before that path and read just after: the flagship path
    # for K1/K2/K9, the split3 path for K3, the manhattan path for K5,
    # activate under manhattan for K8; K4, K6 and K7 serve the shorter
    # runs, whose counts are checked there
    launches = dict(counts)
    launches["bmu_split3"] = counts_paths["split3"]["bmu_split3"]
    launches["bmu_manhattan"] = counts_l1["bmu_manhattan"]
    short = phase_short_runs(torch)
    for name in ("bmu_highest", "bmu_norm_p_odd", "bmu_norm_p_frac"):
        launches[name] = short[name]
    phase_margin_compact(torch, smi)
    launches["manhattan_distance"] = phase_activate(torch, smi)["manhattan_distance"]
    for name, phase in (("bmu_argmin_kb", phase_kblock), ("bmu_stats_fused", phase_fused_epoch)):
        launches[name], errs[name], timings[name], bounds[name] = phase(torch, smi)
    require("jax" not in sys.modules, "JAX was imported")

    record = {
        "card": smi,
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": REPLACES[name][0],
                "replaces": REPLACES[name][1],
                "launches": launches[name],
                "max_abs_err": errs[name],
                "ms": timings[name][0],
                "plain_ms": timings[name][1],
                "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": timings[name][2],
            }
            for name in REPLACES
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
