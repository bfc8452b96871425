#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``xpysom_dask_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernel library from ``xpysom_dask_tpu_torch/csrc``;
  3. each GEMM-form and scatter kernel (K1 packed BMU argmin, K2 its top-2
     form, K9 statistics scatter) against its plain PyTorch version on the
     card: the flagship shape, a ragged shape and a tie fixture, with
     CUDA-event timings;
  4. each register-tiled kernel (K4 exact-f32 GEMM argmin, K5 L1, K6 odd
     p = 3, K7 fractional p = 1.5 (its sqrt branch) and 2.7 (exp/log))
     against its plain version: the flagship chunk,
     K4 at the even-p expansion's width (p = 4, D' = 320), a ragged shape
     and a tie and zero-distance fixture, with CUDA-event timings;
  5. the main path: ``XPySom(128, 128, 64)`` on 2^19 samples, QE before,
     three epochs of a 10-epoch schedule, ``winner``, QE and TE, with the
     kernels' launch counters read around it;
  6. determinism (a second run gives the same codebook bits) and one
     epoch through the plain versions against the kernel path;
  7. the manhattan main path at the same width (QE, 2 of 10 epochs,
     winner/QE/TE, counters, winners against the plain versions) and its
     epoch time on device-resident chunks;
  8. shorter runs (2^16 samples, one epoch) under cosine, norm_p with
     p = 3, 1.5 and 4, and euclidean with ``bmu_precision='highest'``:
     QE falls, the route's kernel launches, and the winners agree with
     the plain versions'.
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

# exact-f32 dot products (K4 and its cuBLAS plain version): each of the
# two sums of D products errs by at most D * 2^-24 * sum_d |x_d||2 w_d|
F32_DOT = 2.0**-24
# K7 (accurate expf/logf, a few ulp per term): the JAX tests' near-tie
# margin (tests/test_pallas.py, relative float64 runner-up margin) and
# value tolerance
FRAC_MARGIN, FRAC_RTOL = 1e-4, 1e-5

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


def _dot_checks(x, w, w_sq):
    """K4's float64 distances and its near-tie band and value tolerance:
    twice the f32 dot bound D * 2^-24 * sum_d |x_d||2 w_d| (two sums, the
    kernel's and cuBLAS's), plus the rounding of the w_sq add."""
    x64, w64, s64 = x.astype(np.float64), w.astype(np.float64), w_sq.astype(np.float64)
    mag = np.abs(x64) @ (2 * np.abs(w64)).max(0)
    tol = 2 * x.shape[1] * F32_DOT * mag + F32_DOT * np.abs(s64).max()

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

    timings = {}
    for label, key in (("K4 flagship", "bmu_highest"), ("K4 p=4 expansion D'=320", None)):
        o = ops[key or "bmu_highest D'=320"]
        t = (cuda_ms(torch, lambda: kb.bmu_highest(*o)),
             cuda_ms(torch, lambda: kb.bmu_highest_plain(*o)))
        if key:
            timings[key] = t
        print(f"time {label}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms (CUDA events; {card})")
    for _, label, *_ in cases:
        key, (xt_, wt_), args, kern, plain = ops[label]
        t = (cuda_ms(torch, lambda: kern(xt_, wt_, *args)),
             cuda_ms(torch, lambda: plain(xt_, wt_, *args), reps=3, warmup=1))
        # the record keeps K7's sqrt branch (p=1.5); the exp/log branch
        # (p=2.7) is printed
        timings.setdefault(key, t)
        print(f"time {label} flagship: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms "
              f"(CUDA events; {card})")
    return timings, errs


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

    # epoch time on device-resident chunks, between two synchronizations
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
    print(f"manhattan epoch on device-resident chunks (host clock, synchronized): "
          f"{[round(t * 1e3, 3) for t in times]} ms; median {med * 1e3:.3f} ms = "
          f"{f['n'] / med / 1e6:.3f} M samples/s")
    return counts


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
        # twice the exact-f32 dot bound (kernel and cuBLAS sums) on the
        # centered operands of -2 x.w + |w|^2
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            return 2 * 2 * d * F32_DOT * (wc @ (2 * xc)).max()
        return band

    def expansion_band(som, p):
        # the same bound on the expansion's D(p+1) products:
        # sum_k |phi_k||psi_k| = sum_d (|x_d - c_d| + |w_d - c_d|)^p
        def band(x, w2, _):
            xc, wc = centered(x, w2, som)
            return 2 * 2 * d * (p + 1) * F32_DOT * ((xc + wc) ** p).sum(1).max()
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
    return launches


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
    t2, e2 = phase_tile_kernels(torch, smi)
    timings.update(t2)
    errs.update(e2)
    data, kw, w3, counts = phase_main_path(torch)
    phase_determinism(torch, data, kw, w3)
    del data
    counts_l1 = phase_manhattan_path(torch)
    # each kernel's launches on the main path that runs it: the flagship
    # path for K1/K2/K9, the manhattan path for K5; K4, K6 and K7 serve
    # the shorter runs, whose counts are checked there
    launches = dict(counts)
    launches["bmu_manhattan"] = counts_l1["bmu_manhattan"]
    short = phase_short_runs(torch)
    for name in ("bmu_highest", "bmu_norm_p_odd", "bmu_norm_p_frac"):
        launches[name] = short[name]
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
