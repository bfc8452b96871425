#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``xpysom_dask_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --te-pass-of DIR   # only the TE pass, of the package in DIR
    python3 chip_smoke.py --manhattan-epoch-of DIR   # only the manhattan epoch, likewise
    python3 chip_smoke.py --dist-cards N     # only phases 18's and 19's ranks: N on NCCL, one a card
    python3 chip_smoke.py --dist-worker RANK WORLD BACKEND DIR   # one rank (phase 18 starts them)
    python3 chip_smoke.py --grid-worker RANK WORLD BACKEND DIR   # one rank (phase 19 starts them)

The second form times ``topographic_error``'s pass (phase 6), the third
the manhattan epoch (phase 9), with the ``xpysom_dask_tpu_torch`` found in
DIR, another checkout of this repository (for example ``git archive`` of
an earlier commit), so two trees can be compared on one card in one call.

Phases (each prints lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of the kernel library from ``xpysom_dask_tpu_torch/csrc``, with
     ptxas's registers and spills per kernel (failing on a serialized
     wgmma, warning C7515 or C7520, or on spills in K10) and, from the SASS
     of the elementwise engine's main loop, its instructions per term;
  3. the wgmma searches' layout pre-pass bit for bit against its plain
     index map; K1 (packed BMU argmin, wgmma) and K2 (its top-2 form, the
     same wgmma search) against their plain PyTorch versions on the card
     (the flagship shape, a ragged shape and a tie fixture; K1 and K2 with
     and without the codebook laid out once and through PackedCodebook,
     bitwise; K2's first place K1's bit for bit), K2 exactly equal to its
     plain version on integer-valued duplicate fixtures (xy = 129, 200,
     259), K1 under the norm_p p = 4 expansion in mode packed, timed
     beside one bf16 cuBLAS product with an f32 output + ``argmin`` (K2:
     + ``topk(2)``) and with each block's A streamed instead of resident,
     then K1's and K2's three feeds (``phase_feeds``: A streamed, pairs
     of row blocks sharing each codebook chunk, A in registers, the first
     two on 256-row codebook tiles; ptxas's report of each instance; bit
     for bit each other on 1, 2, 3 and 129 row blocks at 129, 300 and
     16384 nodes, D = 5, 30, 50, 64, 85 and 500, and on the tie fixtures;
     ``paired``, ``registers`` and ``wide`` counting exactly the launches
     ``search_feed`` routes there; K10 bitwise K1 + K9; K1, K2 and K1's
     feed alone timed on each feed at the flagship chunk, at websom-fit's
     and at packed D = 512, with the bytes they move from L2),
     then K9 (statistics scatter) bitwise against its
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
     bit for bit against the rounding on the bits; the elementwise
     engine's fixtures, K5 and K6 bitwise and K7 within its contract:
     integer-valued data whose exact ties straddle tiles, pipeline stages
     and codebook segments, n below one block, xy below one tile, D = 1 and
     D = 512 (the d-slab path); K7's term against float64 t^p over a sweep
     of t; with CUDA-event timings beside the library call (K4 beside
     ``addmm`` + ``argmin``, with its three-pass TF32 bound and the FP32
     FFMA bound; K5-K7 with the codebook laid out once, as the path calls
     them);
  5. the other precision modes' kernels: K3 (split3, wgmma) and K1/K2
     under the bf16 and split2 operands against their plain versions
     (flagship, ragged, tie fixture; K3 twice bitwise; K2's first place
     K1's bit for bit under bf16), and K8 (the L1
     matrix, on K5's engine) bitwise against its plain version (flagship,
     ragged), with
     CUDA-event timings (K3 beside its three cuBLAS products summed in the
     kernel's order + ``argmin``);
  6. the main path: ``XPySom(128, 128, 64)`` on 2^19 samples, QE before,
     three epochs of a 10-epoch schedule, ``winner``, QE and TE, with the
     kernels' launch counters read around it; then TE's pass over the 32
     device-resident chunks timed (CUDA events, median of 3);
  7. determinism (a second run gives the same codebook bits) and one
     epoch through the plain versions against the kernel path;
  8. the rectangular packed path, the ``bmu_precision='split3'`` path and
     the hexagonal path at the same width (QE, 2 of 10 epochs,
     winner/QE/TE, counters; split3's winners against the plain versions';
     the other two paths' QE and codebooks against the rectangular one's)
     and their epoch times on device-resident chunks;
  9. the manhattan main path at the same width (QE, 2 of 10 epochs,
     winner/QE/TE, counters, winners against the plain versions), then
     the manhattan epoch on device-resident chunks from the initial
     codebook;
 10. shorter runs (2^16 samples, one epoch) under cosine, norm_p with
     p = 3, 1.5 and 4, euclidean with ``bmu_precision='highest'``,
     ``'bf16'``, ``'split2'``, and ``'margin'`` under euclidean and cosine:
     QE falls, the route's kernel launches, and the winners agree with
     the plain versions' (margin's with the float64 argmin);
 11. ``margin`` on one flagship chunk of clustered data whose suspects fit
     the rescue buffer: the compacted re-rank runs, its winners equal the
     plain versions' and the float64 argmin up to the packed floor, and
     its parts (K2 on the bf16 operands beside the rescue) and the host
     read of the suspect count are timed;
 12. ``activate`` under manhattan on 8192 samples x 16384 nodes: K8
     launches and the matrix equals the plain versions' bit for bit; K8
     timed at activate's own chunk;
 13. the wide-D search (K1-kb): ``PackedCodebook.argmin(kblock=)`` at
     (16384, 16384, 512) and (16384, 4096, 1024), modes packed and bf16,
     kblock 512 and 1024, winners and values against the plain version and
     K1, K1-kb on unpadded operands bit for bit its output on operands
     zero-padded to kblock, a ragged shape, a tie fixture across slabs,
     the validation errors, K1 against its own plain version at the same
     shapes, CUDA-event timings of K1-kb, K1, the plain version and one
     bf16 ``mm`` + ``argmin`` over the whole K;
 14. the fused-statistics epoch (K10): two epochs of the flagship
     (128x128x64, 2^19 samples, chunk 16384) whose statistics come from
     K10, bitwise equal to the same epochs from K1 + K9 and to a second
     run; K10 bitwise against K1 + K9 (and two launches equal) on a
     uniform, a ragged and the skewed first chunk, on n = 65536 (512 row
     blocks: the persistent search wraps), 200 x 100 and 200 x 200 nodes
     (the latter: some groups take two node ranges) and D = 200 (two
     column passes), timed per chunk
     against K1 + K9 as an epoch runs them, K10's kernel alone against
     K1's (CUDA events) beside K9's device time, torch.profiler's device
     times by kernel, and per epoch;
 15. checkpoint resume and pickle on the card, and ``autotune_kernel``;
 16. the flagship trained and scored out of core from a file through
     ``FileSource``, bitwise against resident;
 17. ``SomPopulation`` (``phase_population``): two sweeps, 16 maps of
     24 x 24 x 16 on 2^17 rows and 4 of the flagship's maps on its 2^19
     rows, in every strategy, resident and streamed, against lone
     training, the plain versions and each other, with exact K1/K9
     launch counts, epoch times and whether they bear out streamed
     ``'auto'`` running ``'fused'``;
 18. data parallel over ``torch.distributed`` (``phase_distributed``) at
     the flagship's full width: (a) a world of one on NCCL, ``mesh='auto'``
     bitwise equal to ``mesh=None`` (codebook, QE, TE, ``predict``), the
     epoch with and without an NCCL ``all_reduce`` of ``[S | cnt]`` and
     the ``all_reduce`` alone timed; (b) this script run again as
     ``--dist-worker RANK 2 gloo DIR`` in two processes on the one card
     over gloo (NCCL refuses two ranks on one card; ``--dist-cards N``
     runs only (b), N ranks on NCCL, one a card): statistics, two epochs,
     scoring, a checkpoint written by rank 0 and resumed by both, a
     streamed epoch from three shard files split unevenly by
     ``ShardedFileSource`` and a fused population epoch of 4 flagship
     maps, each rank's codebooks bitwise equal to the other's and held
     against one process's;
 19. codebook sharding over (data, model) grids (``phase_grid``) at the
     flagship's full width: (a) a (1, 1) grid on NCCL, a world of one,
     bitwise equal to ``mesh=None`` (codebook after 2 epochs, ``predict``,
     QE, TE) with its K1/K9/K2 launches, and its epoch beside
     ``mesh=None`` and the data mesh of the same world; (b) this script
     run again as ``--grid-worker RANK 4 gloo DIR`` in four processes on
     the one card: a (2, 2) grid (2 epochs, ``predict``, QE, TE, launches
     on each rank) bitwise equal across the ranks and to a 2-rank data
     mesh, and a (1, 2) grid on ranks 0 and 1 bitwise equal to one
     process; each rank's grid epoch beside the data mesh of the same
     world, the per-chunk merge alone and the update's gather alone
     (CUDA events). ``--dist-cards 4`` runs (b) on NCCL, one rank a card,
     with a (1, 4) grid too and one epoch and TE of a 512 x 512 x 64 map
     at (1, 4) on 2^17 rows, bitwise one card's;
 20. ``utils.profiling.epoch_anatomy`` on the flagship (``phase_anatomy``),
     euclidean and manhattan: the BMU, statistics and epoch stages (CUDA
     events, slope over 2 and 8 back-to-back runs, best of 3) beside
     PERF.md's predictions, every value finite, the weights bit for bit
     as they were, and each stage's exact launches (K1 or K5 alone in the
     BMU stage, with K9 in the other two);
 21. the sklearn adapter on the flagship (``phase_sklearn``, where
     scikit-learn imports; otherwise one line says what did not run):
     ``SomClusterer(128, 128, num_epochs=2)`` with no ``device`` bit for
     bit a bare ``XPySom`` (``cluster_centers_``, ``labels_``,
     ``predict``, ``score`` = -QE), ``transform`` within the f32 bound of
     a float64 reference and its argmin ``predict`` but near-ties,
     ``inverse_transform``, exact launches per call, and ``fit``'s host
     wall beside the bare train + predict + QE in turns;
 22. every ``examples_torch/*.py`` (``phase_examples``) in a subprocess
     of its own with no ``--device``, killed at 120 s: exit 0 and
     ``device=cuda`` first; the scripts that need scikit-learn are named
     and skipped where it does not import.
Each kernel's record carries its launches on the path that runs it, its
error against the plain version, its time, the plain version's, the time
of one PyTorch library call that computes the same function where there
is one, and its bound: the least time the card could take, from this
run's shapes and the H100's published peaks, and its registers and
spill bytes from ptxas.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = dict(x=128, y=128, d=64, n=1 << 19, chunk=16384)
FLAGSHIP_KW = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
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
# K7 (t^f on the special-function unit): the JAX tests' near-tie margin
# (tests/test_pallas.py, relative float64 runner-up margin) and value
# tolerance
FRAC_MARGIN, FRAC_RTOL = 1e-4, 1e-5
# the bf16 pass's pairwise error envelope (mode 'margin''s gate, 6 u)
MARGIN_GATE = 6.0 * 2.0**-8

REPLACES = {
    "bmu_argmin": ("xpysom_dask_tpu_torch/csrc/gemm_sm90.cu",
                   "xpysom_dask_tpu/ops/pallas/bmu.py:254"),
    "bmu_top2": ("xpysom_dask_tpu_torch/csrc/gemm_sm90.cu",
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
    "bmu_split3": ("xpysom_dask_tpu_torch/csrc/gemm_sm90.cu",
                   "xpysom_dask_tpu/ops/pallas/bmu.py:212"),
    "manhattan_distance": ("xpysom_dask_tpu_torch/csrc/manhattan.cu",
                           "xpysom_dask_tpu/ops/pallas/manhattan.py:32"),
    "bmu_argmin_kb": ("xpysom_dask_tpu_torch/csrc/gemm_sm90.cu",
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


def _build_root(pkg):
    """The ``build/`` directory beside the package (ignored by git), for
    this run's temporary files."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))), "build")
    os.makedirs(root, exist_ok=True)
    return root


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
    return "; ".join(smi.splitlines())  # one line a card


# csrc/gemm_sm90.cu's search variants, in the order of its enum Search
SEARCHES = ("K1 ARGMIN", "K3 SPLIT3", "K2 TOP2", "K1-kb KBLOCKED", "FEED")


def _kernel_name(mangled):
    """The last component of a mangled kernel name (plus the gemm_sm90
    variant and its feed: ``pair``, or ``A in registers xN`` for N chunks,
    and ``wide`` on 256-row codebook tiles; or the tile_argmin.cuh term and
    epilogue): ``_ZN<len><name><len><name>...``."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else "", mangled
    while rest[:1].isdigit():
        n = int(re.match(r"\d+", rest).group())
        rest = rest[len(str(n)):]
        name, rest = rest[:n], rest[n:]
    v = re.search(r"SearchE(\d)E(?:Li(\d+)ELi(\d+)E(?:Li\d+ELb([01])E)?)?", mangled)
    if v:
        cluster, ra = int(v.group(2) or 1), int(v.group(3) or 0)
        tail = (" pair" if cluster > 1 else "") + (f" A in registers x{ra}" if ra else "") + (
            " wide" if v.group(4) == "1" else "")
        return f"{name} <{SEARCHES[int(v.group(1))]}>{tail}"
    t = re.search(r"(L1Term|PowTerm|FracTerm)(?:I((?:L[bi]n?\d+E)+)E)?ELb([01])E", mangled)
    if t:
        args = [{"b0": "false", "b1": "true"}.get(k + a, a.replace("n", "-"))
                for k, a in re.findall(r"L([bi])(n?\d+)E", t.group(2) or "")]
        term = t.group(1) + (f"<{', '.join(args)}>" if args else "")
        return f"{name} <{term}, {'store' if t.group(3) == '1' else 'search'}>"
    return name


def ptxas_report(log):
    """``{kernel: (registers, spill store bytes, spill load bytes)}`` from
    ``nvcc -Xptxas -v`` output."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill)
            cur, spill = None, (0, 0)
    return out


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_per_term(sass):
    """``{engine instance: (instructions, special-function instructions)
    per term}`` from ``cuobjdump -sass`` output: the straight-line block of
    each tile_kernel search instance with the most shared-memory loads is
    its unrolled main loop, where four 16-byte loads feed 64 terms."""
    out = {}
    for name, body in zip(*(lambda p: (p[1::2], p[2::2]))(
            re.split(r"\n\s*Function : (\S+)\n", sass))):
        label = _kernel_name(name)
        if not label.startswith("tile_kernel") or "store" in label:
            continue
        blocks = [[]]
        for line in body.splitlines():
            if re.match(r"^\s*\.L_x_\d+:", line):
                blocks.append([])
                continue
            m = _SASS_OP.search(line)
            if m:
                blocks[-1].append(m.group(1))
                if m.group(1).startswith(("BRA", "EXIT", "RET")):
                    blocks.append([])
        loop = max(blocks, key=lambda b: sum(op.startswith("LDS") for op in b))
        terms = 16 * sum(op.startswith("LDS") for op in loop)
        if terms:
            out[label] = (len(loop) / terms, sum(op.startswith("MUFU") for op in loop) / terms)
    return out


def phase_build():
    """Builds the library; prints and returns ptxas's ``{kernel:
    (registers, spill stores, spill loads)}`` and the engine's SASS
    instructions per term."""
    import shutil

    from xpysom_dask_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    took = time.perf_counter() - t0
    print(f"build: kernel library ready in {took:.2f} s "
          f"(nvcc {build.last_build_seconds if build.last_build_seconds is not None else 'cached'})")
    log = getattr(build, "last_build_log", None)  # an older tree's build keeps none
    report = ptxas_report(log) if log else {}
    for name, (regs, st, ld) in sorted(report.items()):
        print(f"ptxas: {name}: {regs} registers, spill stores {st} bytes, spill loads {ld} "
              "bytes (sm_90a)")
    if log:
        # ptxas serializes wgmmas whose accumulators other instructions touch
        # in flight (C7515) or that lie on a path it takes as divergent
        # (C7520): either costs a wgmma search most of its speed
        serial = [line for line in log.splitlines() if re.search(r"C75(15|20)", line)]
        require(not serial, "ptxas serialized wgmmas:\n" + "\n".join(serial))
        k10 = report.get("fused_stats_kernel")
        require(k10 is not None, "ptxas reported no fused_stats_kernel (K10)")
        require(k10[1] == k10[2] == 0, f"K10 spills: {k10}")
        print(f"build log: no wgmma serialized (C7515/C7520); K10 {k10[0]} registers, no spills")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build.build_dir() / f"libxpysom_kernels_{build._digest()}.so"
    if log and os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        for name, (per_term, sfu) in sorted(sass_per_term(sass).items()):
            print(f"SASS: {name}: {per_term:.3f} instructions a term, {sfu:.3f} of them "
                  "special-function (the unrolled main loop)")
    return report


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


def _bits_equal(torch, got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def compare_bmu(torch, kb, name, x, w):
    """Kernel vs plain for K1 and K2 on (x, w), packed as the main path
    packs them; K1 and K2 with the codebook laid out per call and laid out
    once (``PackedCodebook.laid``) and through ``PackedCodebook`` (the
    samples packed and laid out in one pass), all bitwise equal, and K2's
    first place K1's bit for bit. Returns the K1/K2 max absolute value
    errors, the operands for timing, K1's indices and the laid-out
    codebook."""
    xt = torch.from_numpy(x).cuda()
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda())
    a, w_aug, xy = cb.operands(xt)
    center = cb.center.cpu().numpy()
    xc = (x - center).astype(np.float64)
    wc = (w - center).astype(np.float64)

    i_k, v_k = kb.bmu_argmin(a, w_aug, xy)
    laid = cb.laid()[0]
    for again in (kb.bmu_argmin(a, w_aug, xy, w_laid=laid), kb.bmu_argmin(a, w_aug, xy),
                  cb.argmin(xt)):
        require(torch.equal(again[0], i_k) and torch.equal(again[1].view(torch.int32),
                                                           v_k.view(torch.int32)),
                f"{name}: K1 launches (codebook laid out once / per call, samples packed "
                "in one pass) differ in bits")
    i_p, v_p = kb.bmu_argmin_plain(a, w_aug, xy)
    t = kb.bmu_top2(a, w_aug, xy)
    for again in (kb.bmu_top2(a, w_aug, xy, w_laid=laid), cb.top2(xt)):
        require(_bits_equal(torch, again, t), f"{name}: K2 launches (codebook laid out once / "
                "per call, samples packed in one pass) differ in bits")
    require(_bits_equal(torch, t[:2], (i_k, v_k)), f"{name}: K2's first place is not K1's bits")
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

    diff2 = np.nonzero((t[0] != tp[0]) | (t[2] != tp[2]))[0]
    _check_near_ties(f"{name} K2 first", diff2, xc, wc, t[0], tp[0])
    _check_near_ties(f"{name} K2 second", diff2, xc, wc, t[2], tp[2])
    same2 = (t[0] == tp[0]) & (t[2] == tp[2])
    err2 = float(max(np.abs(t[1] - tp[1])[same2].max(), np.abs(t[3] - tp[3])[same2].max())) \
        if same2.any() else 0.0
    require((np.abs(t[3] - tp[3]) <= tol)[same2].all(), f"{name}: K2 values disagree")
    print(f"{name}: K1 {len(diff1)} near-tie index differences of {n}, max|dv| {err1:.3g}; "
          f"K2 {len(diff2)} near-tie differences, max|dv| {err2:.3g}; K1's and K2's launches "
          "bitwise equal, K2's first place K1's bits")
    return err1, err2, (a, w_aug, xy), i_k, laid


def _mm_f32(torch):
    """One bf16 cuBLAS product with an f32 output, and its label:
    ``torch.mm(..., out_dtype=torch.float32)`` where the installed torch
    takes it, else the bf16 product cast to f32."""
    one = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(one, one, out_dtype=torch.float32)
        return (lambda x, y: torch.mm(x, y, out_dtype=torch.float32),
                "f32 output by torch.mm(out_dtype=float32)")
    except (TypeError, RuntimeError):
        return (lambda x, y: torch.mm(x, y).float(),
                "bf16 output cast to f32: this torch's mm takes no out_dtype")


def _top2_duplicates(xy, n, rng):
    """Integer-valued f32 distances (N, XY) holding the ties K2's finish
    must order, and one-hot bf16 operands ``(A, W_aug)`` whose product is
    exactly that matrix (one product per sum, every value exact in bf16):
    a duplicate minimum in one thread's own columns (0 and 8), in another
    quad lane (0 and 2), across tiles (0 and 128, 127 and 128), a runner-up
    that ties the winner's value at a lower index than a third (5, 64,
    128), a duplicated runner-up value, the last column first or second,
    all columns equal, and rows of small random integers (dense ties)."""
    base = (40 + (np.arange(xy) * 7) % 50).astype(np.float32)
    rows = []
    for at in ({0: 1, 8: 1}, {0: 1, 2: 1}, {0: 1, 128: 1}, {127: 1, 128: 1},
               {5: 1, 64: 1, 128: 1}, {50: 1, 100: 2, 20: 2}, {0: 1, 1: 1},
               {1: 1, 3: 2, 6: 2}, {xy - 1: 0, 3: 1}, {10: 0, xy - 1: 1}):
        r = base.copy()
        for c, v in at.items():
            r[c % xy] = v
        rows.append(r)
    rows.append(np.full(xy, 7, np.float32))
    while len(rows) < 32:
        rows.append(rng.randint(0, 4, size=xy).astype(np.float32))
    table = np.stack(rows)
    a = np.zeros((n, len(table)), np.float32)
    a[np.arange(n), rng.permutation(np.arange(n) % len(table))] = 1
    w_aug = np.zeros((len(table), -(-xy // 8) * 8), np.float32)
    w_aug[:, :xy] = table
    return a, w_aug


def _check_top2_duplicates(torch, kb):
    """K2 against its plain version on the duplicate fixtures, exactly:
    indices and values bit for bit, at xy = 129 (the last tile holds one
    column), 200 and 259, ragged rows."""
    rng = np.random.RandomState(13)
    for xy in (129, 200, 259):
        a, w_aug = (torch.from_numpy(t).to(torch.bfloat16).cuda()
                    for t in _top2_duplicates(xy, 333, rng))
        got, want = kb.bmu_top2(a, w_aug, xy), kb.bmu_top2_plain(a, w_aug, xy)
        torch.cuda.synchronize()
        require(_bits_equal(torch, got, want),
                f"K2 duplicate fixture xy={xy}: differs from the plain version")
        ties = int((got[1] == got[3]).sum())
        require(ties >= 333 // 4, f"K2 duplicate fixture xy={xy}: only {ties} tied runner-ups")
    print("K2 duplicate fixtures (xy = 129, 200, 259; 333 rows): equal to the plain version bit "
          "for bit in idx, val, idx2, val2")


def _check_layout(torch, kb):
    """The layout pre-pass on the card bit for bit against its plain index
    map: the flagship samples' A and codebook rows (vector and strided
    reads), a ragged operand and a strided one with K off the chunk
    depth, in both tile heights."""
    rng = np.random.RandomState(12)
    f = FLAGSHIP
    cb = kb.PackedCodebook(torch.from_numpy(rng.rand(f["x"] * f["y"], f["d"]).astype(
        np.float32)).cuda())
    a, w_aug, xy = cb.operands(torch.from_numpy(rng.rand(f["chunk"], f["d"]).astype(
        np.float32)).cuda())
    cases = [("flagship A", a, kb.GEMM_BM), ("flagship codebook", w_aug[:, :xy].T, kb.K1_BN),
             ("ragged 1000x32", a[:1000, :32], kb.GEMM_BM),
             ("strided 333x37", torch.randn(37, 333, device="cuda").to(torch.bfloat16).T,
              kb.K3_BN)]
    for label, t, trows in cases:
        got, want = kb.lay_out(t, trows), kb.lay_out_plain(t, trows)
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                f"layout pre-pass, {label}: differs from the plain index map")
    # the samples packed and laid out in one pass, against pack_samples /
    # split3_samples laid out by the plain index map, centered or not
    x = torch.from_numpy((rng.randn(f["chunk"], f["d"]) * 3).astype(np.float32)).cuda()
    parts = ("packed", "bf16", "split2", "split3_hi", "split3_lo")
    for rows, center in ((f["chunk"], cb.center), (1000, None)):
        xs = x[:rows]
        x_c = xs if center is None else xs - center[None, :]
        for part in parts:
            got = kb.lay_out_samples(xs, center, part)
            want = kb.lay_out_plain(kb._sample_operand_plain(x_c, part), kb.GEMM_BM)
            require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                    f"packing pre-pass, {part}, {rows} rows: differs from the plain version")
    print(f"layout pre-pass: bitwise equal to the plain index map on {len(cases)} operands; "
          f"the samples' packing pre-pass on {2 * len(parts)} (modes x centering)")


def _check_k1_norm_p4(torch, kb, x, w):
    """K1 under the norm_p p = 4 expansion in mode packed (K = 976) on the
    flagship chunk against its plain version on the same operands: winners
    equal up to f32 ties of the operands, values within the f32
    accumulation bound; timed. Returns the max value error."""
    xt, wt = torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()
    cb = kb.NormPEvenCodebook(wt, 4, "packed")
    a, w_aug, xy = cb.operands(xt)
    i_k, v_k = cb.argmin(xt)
    i_p, v_p = kb.bmu_argmin_plain(a, w_aug, xy)
    torch.cuda.synchronize()
    diff = np.nonzero((i_k != i_p).cpu().numpy())[0]
    _check_operand_ties("K1 norm_p p=4 packed", diff, a, w_aug, i_k.cpu().numpy(),
                        i_p.cpu().numpy())
    same = i_k == i_p
    with_ties = (a.float().abs() @ w_aug[:, :xy].float().abs()).amax(1)
    tol = 2 * a.shape[1] * F32_U * with_ties
    err = (v_k - v_p).abs()
    require(bool((err <= tol)[same].all()), "K1 norm_p p=4 packed: values disagree")
    laid = cb._gemm.laid()[0]
    ms = cuda_ms(torch, lambda: kb.bmu_argmin(a, w_aug, xy, w_laid=laid))
    print(f"K1 norm_p p=4 packed ({x.shape[0]}x{xy}, K = {a.shape[1]}): {len(diff)} tie index "
          f"differences, max|dv| {float(err[same].max()):.3g}; {ms:.4f} ms (CUDA events)")
    return float(err[same].max())


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


def _profile_kernels(torch, fn, names):
    """``{name: device us}`` of one call of ``fn`` for kernels whose names
    contain each of ``names`` (torch.profiler, up to three traces until
    every one shows); empty where a trace never did."""
    for _ in range(3):
        split = _profile_split(torch, fn)
        got = {n: sum(v for k, v in split.items() if n in k) for n in names}
        if all(any(n in k for k in split) for n in names):
            return got
    return {}


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
    _check_layout(torch, kb)
    err1, err2, ops, idx, laid = compare_bmu(torch, kb, "flagship 16384x16384 D=64", x, w)

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
    *_, (a, w_aug, xy), _, _ = compare_bmu(torch, kb, "tie fixture", xt, wt)
    i1, _, i2, v2 = (u.cpu().numpy() for u in kb.bmu_top2(a, w_aug, xy))
    i0, _ = kb.bmu_argmin(a, w_aug, xy)
    require(i0.cpu().numpy().tolist() == [0, 7, 0, 0], f"tie fixture: K1 {i0.tolist()}")
    require(i1.tolist() == [0, 7, 0, 0] and i2.tolist() == [1, 1500, 1, 1],
            f"tie fixture: K2 {i1.tolist()} {i2.tolist()}")
    _check_top2_duplicates(torch, kb)

    err4 = _check_k1_norm_p4(torch, kb, x, w)
    err1 = max(err1, err4)

    # K1 as the main path calls it: the codebook laid out once per epoch,
    # the samples' A laid out in the call
    a, w_aug, xy = ops
    mm_f32, mm_label = _mm_f32(torch)
    timings = {
        "bmu_argmin": (cuda_ms(torch, lambda: kb.bmu_argmin(*ops, w_laid=laid)),
                       cuda_ms(torch, lambda: kb.bmu_argmin_plain(*ops)),
                       cuda_ms(torch, lambda: mm_f32(a, w_aug[:, :xy]).argmin(1))),
        "bmu_top2": (cuda_ms(torch, lambda: kb.bmu_top2(*ops, w_laid=laid)),
                     cuda_ms(torch, lambda: kb.bmu_top2_plain(*ops)),
                     cuda_ms(torch, lambda: torch.topk(mm_f32(a, w_aug[:, :xy]), 2, dim=1,
                                                       largest=False))),
    }
    for name, (ms, plain, _) in timings.items():
        print(f"time {name} at the flagship chunk: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(CUDA events; {card})")
    a_laid = kb.lay_out(a, kb.GEMM_BM)
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda())
    xt = torch.from_numpy(x).cuda()
    parts = {
        "library (one bf16 cuBLAS product, " + mm_label + ", + argmin; a composition of "
        "calls)": timings["bmu_argmin"][2],
        "the search as an epoch runs it (PackedCodebook.argmin: centering, the samples "
        "packed and laid out in one pass, K1)": cuda_ms(torch, lambda: cb.argmin(xt)),
        "K1 laying the codebook out in the call too": cuda_ms(torch, lambda: kb.bmu_argmin(*ops)),
        "the samples' layout pre-pass": cuda_ms(torch, lambda: kb.lay_out(a, kb.GEMM_BM)),
        "the codebook's layout pre-pass": cuda_ms(
            torch, lambda: kb.lay_out(w_aug[:, :xy].T, kb.K1_BN)),
        **{f"K1's kernel alone, {FEED_NAMES[feed]}": cuda_ms(
            torch, lambda: kb._gemm_sm90("xps_gemm_argmin", (a_laid, laid), a.shape[0],
                                         a.shape[1], xy, feed)) for feed in FEED_NAMES},
    }
    for label, ms in parts.items():
        print(f"time bmu_argmin (K1) at the flagship chunk (K = {a.shape[1]}), {label}: "
              f"{ms:.4f} ms (CUDA events; {card})")
    parts = {
        "library (one bf16 cuBLAS product, " + mm_label + ", + topk(2, largest=False); a "
        "composition of calls)": timings["bmu_top2"][2],
        "the search as TE runs it (PackedCodebook.top2: centering, the samples packed and "
        "laid out in one pass, K2)": cuda_ms(torch, lambda: cb.top2(xt)),
        "K2 laying the codebook out in the call too": cuda_ms(torch, lambda: kb.bmu_top2(*ops)),
        **{f"K2's kernel alone, {FEED_NAMES[feed]}": cuda_ms(
            torch, lambda: kb._gemm_sm90("xps_gemm_top2", (a_laid, laid), a.shape[0],
                                         a.shape[1], xy, feed, outs=4)) for feed in FEED_NAMES},
    }
    for label, ms in parts.items():
        print(f"time bmu_top2 (K2) at the flagship chunk (K = {a.shape[1]}), {label}: "
              f"{ms:.4f} ms (CUDA events; {card})")
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


# K1's and K2's feeds (csrc/gemm_sm90.cu; ops/kernels/bmu.py search_feed),
# by the entries' codes
FEED_NAMES = {0: "A streamed, one block a row block", 1: "pairs of row blocks sharing each "
              "codebook chunk", 2: "A in registers, one block a row block"}
# (samples, nodes, D) whose rows make 1, 2, 3 and 129 row blocks, at 129 and
# 16384 nodes (D = 64, K = 208: A in registers four chunks deep) and at a
# reduced WEBSOM width (D = 500, K = 1504: A streamed or pairs, on 256-row
# tiles); then A in registers one, two and three chunks deep (D = 5, 30,
# 50: K = 32, 96, 160); then three laid-out tiles (the last 256-row tile
# has one) at K = 1504 and at K = 272 (a last depth chunk of 16)
FEED_SHAPES = tuple((n, xy, d) for d, xys in ((64, (129, 16384)), (500, (3000,)))
                    for xy in xys for n in (64, 129, 384, 16384 + 64)) + (
    (384, 3000, 5), (384, 3000, 30), (16384 + 64, 16384, 50), (384, 300, 500), (129, 300, 85))
# websom-fit's chunk: 16384 rows of 500 attributes against 1044 x 960 units
WEBSOM_CHUNK = (16384, 1044 * 960, 500)
# the flagship chunk at packed D = 512 (K = 1552, A streamed), where K1 lost
# to one cuBLAS product + argmin
D512_CHUNK = (16384, 16384, 512)


def _feeds(kb, k):
    """The feeds K1 and K2 take at depth k: A in registers only up to
    REGISTER_K."""
    return [f for f in FEED_NAMES if f != kb.FEED_REGISTERS or -(-k // 16) * 16 <= kb.REGISTER_K]


def _search_fed(torch, kb, entry, a_laid, w_laid, n, k, xy, feed):
    """K1 (``entry`` ``xps_gemm_argmin``) or K2 (``xps_gemm_top2``) on
    laid-out operands on a given feed, not the one ``search_feed`` picks."""
    return kb._gemm_sm90(entry, (a_laid, w_laid), n, k, xy, feed,
                         outs=2 if entry == "xps_gemm_argmin" else 4)


def _feed(torch, a_laid, w_laid, n, k, xy, cluster):
    """K1's feed alone (csrc/gemm_sm90.cu ``xps_gemm_feed``): K1's grid,
    ring and copies with A streamed, no product; cluster 1 or 2 (pairs)."""
    from xpysom_dask_tpu_torch.ops.kernels import build

    rc = build.load_library().xps_gemm_feed(
        a_laid.data_ptr(), w_laid.data_ptr(), n, -(-k // 16) * 16, xy, cluster,
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gemm_feed")


def _feed_bytes(n, xy, k, feed):
    """``(to the SMs, from L2)``: the bytes a feed of K1 moves for one
    search of n rows against xy units at depth k. A streamed: every row
    block's A chunks once for every 256-row codebook tile, beside every
    codebook chunk; pairs (feed 1): the same into each block, but each
    codebook chunk read once a pair, and a pair's block past the rows
    reads no A; A in registers (feed 2): each row block's A once, then the
    codebook chunks."""
    k16 = -(-k // 16) * 16
    rb, laid = -(-n // 128), -(-xy // 128)
    pair = 2 if feed == 1 else 1
    blocks = -(-rb // pair) * pair
    a = rb * 128 * k16 * 2 * (1 if feed == 2 else -(-laid // 2))
    b = laid * 128 * k16 * 2
    return a + blocks * b, a + blocks // pair * b


def _time_feeds(torch, fn, feeds, reps, warmup):
    """``{feed: [ms, ms]}``: ``fn(feed)`` timed by CUDA events in the order
    of ``feeds`` and then back."""
    out = {f: [] for f in feeds}
    for f in feeds + feeds[::-1]:
        out[f].append(cuda_ms(torch, lambda: fn(f), reps=reps, warmup=warmup))
    return out


def _feed_bits(torch, kb, name, x, w):
    """On (x, w) packed as the main path packs them: K1 and K2 on every
    feed the depth takes equal A streamed on one block a row block bit for
    bit (pairs over one row block: the pair's second block past the rows),
    and the routed searches (``PackedCodebook.argmin``/``.top2``) are those
    bits; then ``compare_bmu`` against the plain versions. Returns the
    routed feed."""
    xt = torch.from_numpy(x).cuda()
    cb = kb.PackedCodebook(torch.from_numpy(w).cuda())
    n, d = x.shape
    k, xy = 3 * d + 3, cb.xy
    w_laid = cb.laid()[0]
    a_laid = kb.lay_out_samples(xt, cb.center, "packed")
    for entry, routed in (("xps_gemm_argmin", cb.argmin), ("xps_gemm_top2", cb.top2)):
        one = _search_fed(torch, kb, entry, a_laid, w_laid, n, k, xy, kb.FEED_STREAMED)
        for feed in _feeds(kb, k)[1:]:
            require(_bits_equal(torch, _search_fed(torch, kb, entry, a_laid, w_laid, n, k, xy,
                                                   feed), one),
                    f"feeds, {name}: {entry} with {FEED_NAMES[feed]} differs in bits from A "
                    "streamed")
        require(_bits_equal(torch, routed(xt), one), f"feeds, {name}: the routed {entry} "
                "differs in bits from A streamed")
    compare_bmu(torch, kb, f"feeds, {name}", x, w)
    return kb.search_feed(n, k, xy)


def phase_feeds(torch, card, ptxas):
    """K1's and K2's feeds (``xps_gemm_argmin``'s and ``xps_gemm_top2``'s
    ``feed``): ptxas's registers and spills of each instance, the deep
    feeds' on 256-row tiles; every feed bit for bit A streamed's at every
    shape of FEED_SHAPES and on the tie fixtures, and against the plain
    versions; ``paired``, ``registers`` and ``wide`` counting exactly the
    launches that ``search_feed`` sends there; K10 (A streamed) bitwise K1
    (A in registers) + K9 on the flagship chunk; then K1, K2 and K1's feed
    alone (``xps_gemm_feed``: the ring's copies, no product) timed on each
    feed at the flagship chunk, whose operands stay in L2, at websom-fit's
    chunk and at the flagship chunk at packed D = 512, beside the bytes
    they move to the SMs and read from L2."""
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import fused_stats as kf
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    for search, count in (("K1 ARGMIN", 6), ("K2 TOP2", 6), ("FEED", 2)):
        fed = {k: v for k, v in ptxas.items() if k.startswith(f"gemm_sm90_kernel <{search}>")}
        require(len(fed) == count, f"ptxas: {search}: {sorted(fed)} ({count} instances "
                "expected)")
        # the deep feeds (A streamed, pairs) on 256-row tiles, A in registers on 128
        wide = sorted(k for k in fed if k.endswith(" wide"))
        require(len(wide) == 2 and not any("registers" in k for k in wide),
                f"ptxas: {search}: the 256-row instances {wide}")
        for label, regs in sorted(fed.items()):
            require(regs[1] == regs[2] == 0, f"{label} spills: {regs}")
            print(f"feeds: ptxas {label}: {regs[0]} registers, no spills (sm_90a)")

    rng = np.random.RandomState(20)
    kernels.reset_launch_counts()
    routed = []
    for n, xy, d in FEED_SHAPES:
        x = rng.rand(n, d).astype(np.float32)
        w = (rng.rand(xy, d) * 2 - 1).astype(np.float32)
        routed.append(_feed_bits(torch, kb, f"{n}x{xy} D={d}", x, w))
    require(routed.count(kb.FEED_REGISTERS) == 2 * 4 + 3 and kb.FEED_PAIRS not in routed,
            f"feeds: the shapes routed {routed}")
    counts = kernels.launch_counts()
    # per shape: _feed_bits' routed K1 and K2, then compare_bmu's 4 K1 and 3
    # K2 launches through the wrappers, each on the shape's feed
    want = {"bmu_argmin": 5 * len(FEED_SHAPES), "bmu_top2": 4 * len(FEED_SHAPES)}
    for name, per in (("bmu_argmin", 5), ("bmu_top2", 4)):
        want[f"{name}.paired"] = per * routed.count(kb.FEED_PAIRS)
        want[f"{name}.registers"] = per * routed.count(kb.FEED_REGISTERS)
        want[f"{name}.wide"] = per * (len(routed) - routed.count(kb.FEED_REGISTERS))
        want[f"{name}.streamed"] = per * routed.count(kb.FEED_STREAMED)
    got = {k: counts[k] for k in want}
    require(got == want, f"feeds: launches {got}, expected {want}")
    print(f"feeds: K1 and K2 bitwise equal on every feed on {len(FEED_SHAPES)} shapes "
          f"{FEED_SHAPES}; the counters count exactly the feeds search_feed picked: {got}")

    # the tie fixture (duplicated codebook rows: the first index wins, the
    # duplicate is K2's runner-up) on one row block and repeated over three
    xt = np.zeros((4, 3), np.float32)
    xt[1] = 5
    wt = np.zeros((2100, 3), np.float32)
    wt[7] = 5
    wt[1500] = 5
    for rows in (4, 260):
        x = np.tile(xt, (rows // 4, 1))
        _feed_bits(torch, kb, f"tie fixture, {rows} rows", x, wt)
        a, w_aug, xy = kb.PackedCodebook(torch.from_numpy(wt).cuda()).operands(
            torch.from_numpy(x).cuda())
        i1, _, i2, _ = (u.cpu().numpy() for u in kb.bmu_top2(a, w_aug, xy))
        require(i1.tolist() == [0, 7, 0, 0] * (rows // 4) and
                i2.tolist() == [1, 1500, 1, 1] * (rows // 4),
                f"feeds, tie fixture, {rows} rows: K2 {i1[:8].tolist()} {i2[:8].tolist()}")

    # K10 runs the streamed search: bitwise K1 on its feed, then K9
    f = FLAGSHIP
    x = torch.from_numpy(rng.rand(f["chunk"], f["d"]).astype(np.float32)).cuda()
    w = torch.from_numpy((rng.rand(f["x"] * f["y"], f["d"]) * 2 - 1).astype(np.float32)).cuda()
    m = torch.from_numpy((rng.rand(f["chunk"]) > 0.05).astype(np.float32)).cuda()
    cb = kb.PackedCodebook(w, "packed", center=False)
    i_f, acc = kf.bmu_stats_fused(x, cb, m)
    i_1, _ = cb.argmin(x)
    acc9 = ks.scatter_stats(x, m, i_1, cb.xy)
    torch.cuda.synchronize()
    require(torch.equal(i_f, i_1) and torch.equal(acc.view(torch.int32), acc9.view(torch.int32)),
            "feeds: K10 differs from K1 (A in registers) + K9 in bits")
    print("feeds: K10 (A streamed) bitwise equal to K1 (A in registers) + K9 on the flagship "
          "chunk")

    for label, (n, xy, d), reps, warmup in (
            ("the flagship chunk", (f["chunk"], f["x"] * f["y"], f["d"]), 20, 3),
            ("websom-fit's chunk", WEBSOM_CHUNK, 3, 1),
            ("the flagship chunk at packed D = 512", D512_CHUNK, 10, 2)):
        g = torch.Generator(device="cuda").manual_seed(n + xy + d)
        x = torch.rand(n, d, device="cuda", generator=g)
        cb = kb.PackedCodebook(torch.rand(xy, d, device="cuda", generator=g) * 2 - 1)
        w_laid = cb.laid()[0]
        a_laid = kb.lay_out_samples(x, cb.center, "packed")
        k = 3 * d + 3
        feeds = _feeds(kb, k)
        before = kernels.launch_counts()
        routed = [cb.argmin(x), cb.top2(x)]
        after = kernels.launch_counts()
        feed = kb.search_feed(n, k, xy)
        for name, out in zip(("bmu_argmin", "bmu_top2"), routed):
            entry = "xps_gemm_argmin" if name == "bmu_argmin" else "xps_gemm_top2"
            for other in feeds:
                require(_bits_equal(torch, _search_fed(torch, kb, entry, a_laid, w_laid, n, k,
                                                       xy, other), out),
                        f"feeds, {label}: {entry} with {FEED_NAMES[other]} differs in bits")
            moved = {key: after[key] - before[key] for key in after
                     if key.startswith(name + ".") and after[key] != before[key]}
            want = {f"{name}.registers": 1} if feed == kb.FEED_REGISTERS else {
                f"{name}.wide": 1,
                f"{name}.paired" if feed == kb.FEED_PAIRS else f"{name}.streamed": 1}
            require(moved == want, f"feeds, {label}: {name} counted {moved}, expected {want}")
        print(f"feeds, {label}: the routed K1 and K2 took {FEED_NAMES[feed]}, bitwise every "
              "other feed's")
        runs = {
            "K1 (xps_gemm_argmin)": (feeds, lambda fd: _search_fed(
                torch, kb, "xps_gemm_argmin", a_laid, w_laid, n, k, xy, fd)),
            "K2 (xps_gemm_top2)": (feeds, lambda fd: _search_fed(
                torch, kb, "xps_gemm_top2", a_laid, w_laid, n, k, xy, fd)),
            "K1's feed alone (xps_gemm_feed)": ([0, 1], lambda fd: _feed(
                torch, a_laid, w_laid, n, k, xy, 2 if fd == 1 else 1)),
        }
        for what, (fds, fn) in runs.items():
            t = _time_feeds(torch, fn, fds, reps, warmup)
            for fd in fds:
                ms = sum(t[fd]) / len(t[fd])
                to_sm, from_l2 = _feed_bytes(n, xy, k, fd)
                print(f"time feeds, {label} ({n} x {xy}, K = {k}), {what}, {FEED_NAMES[fd]}: "
                      f"{ms:.4f} ms ({t[fd][0]:.4f}, {t[fd][1]:.4f}); {to_sm / 1e9:.4f} GB to the "
                      f"SMs at {to_sm / ms / 1e9:.3f} TB/s, {from_l2 / 1e9:.4f} GB from L2 at "
                      f"{from_l2 / ms / 1e9:.3f} TB/s (CUDA events, {reps} calls after "
                      f"{warmup}; {card})")
        del a_laid, w_laid, cb, x
        torch.cuda.empty_cache()


def phase_main_path(torch):
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    data = np.random.RandomState(0).rand(f["n"], f["d"]).astype(np.float32)
    kw = FLAGSHIP_KW
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
    # packed D = 64 (K = 208): every launch holds A in registers
    require(counts["bmu_argmin.registers"] == counts["bmu_argmin"] and
            counts["bmu_top2.registers"] == counts["bmu_top2"],
            f"the main path's K1 and K2 did not all hold A in registers: {counts}")

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


def phase_te_pass(torch, card, tree="this tree"):
    """``core.make_topographic_stats_fn`` over the flagship's 32
    device-resident chunks under the initial codebook of
    ``XPySom(128, 128, 64, random_seed=0)``: one warm-up, then three
    passes between CUDA events; prints the median and TE. Returns the
    median in ms."""
    from xpysom_dask_tpu_torch import XPySom, core

    f = FLAGSHIP
    data = np.random.RandomState(0).rand(f["n"], f["d"]).astype(np.float32)
    som = XPySom(f["x"], f["y"], f["d"], sigma=64, sigmaN=1, learning_rate=0.5,
                 learning_rateN=0.01, random_seed=0)
    chunks, mask, _ = som._chunked(data)
    fn = core.make_topographic_stats_fn(som._spec)
    w = som._device_weights()
    errs, cnt = fn(w, chunks, mask)
    te = float(errs) / float(cnt)
    require(0.0 <= te <= 1.0, f"TE pass: TE {te} outside [0, 1]")
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(w, chunks, mask)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = sorted(times)[1]
    print(f"TE over 2^19 samples: median {med:.4f} ms of {[round(t, 4) for t in times]} "
          f"({chunks.shape[0]} device-resident chunks of {chunks.shape[1]}, initial codebook, "
          f"TE {te!r}; CUDA events; {tree}; {card})")
    return med


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
        # 10, 11, 12; row 7 duplicated at 9 (same tile) and 1500 (tile 11,
        # another codebook segment: four rows take 17 segments of a tile)
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

    # more counts of the multiply chain (tile_argmin.cuh: a template
    # argument for K6's p = 3 and K7's floor(p) <= 2, else a run-time
    # count): odd p with 0, 4 and 8 multiplies; fractional p with 0, 3 and
    # 4, through both branches (sqrt for 0.5 and 4.5)
    for p in (1, 5, 9):
        compare_tile(torch, f"K6 p={p} ragged", ke.bmu_norm_p_odd, ke.bmu_norm_p_odd_plain,
                     xr, wr, p, exact=True)
    for p in (0.5, 3.3, 4.5):
        errs["bmu_norm_p_frac"] = max(errs["bmu_norm_p_frac"],
                                      _compare_frac(torch, f"K7 p={p} ragged", xr, wr, p)[0])
    for key, err in _check_engine_fixtures(torch).items():
        errs[key] = max(errs[key], err)
    _frac_term_sweep(torch, card)

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
    from xpysom_dask_tpu_torch.ops.kernels.tile import EW_BN, lay_out_f32

    laid = lay_out_f32(ops["K5"][1][1], EW_BN)  # the codebook, laid out once per epoch
    print(f"time the codebook's layout pre-pass (16384 x 64): "
          f"{cuda_ms(torch, lambda: lay_out_f32(ops['K5'][1][1], EW_BN)):.4f} ms (CUDA events; "
          f"{card})")
    for _, label, *_ in cases:
        key, (xt_, wt_), args, kern, plain = ops[label]
        p = args[0] if args else 1
        t = (cuda_ms(torch, lambda: kern(xt_, wt_, *args, w_laid=laid)),
             cuda_ms(torch, lambda: plain(xt_, wt_, *args), reps=3, warmup=1),
             cuda_ms(torch, lambda: torch.cdist(xt_, wt_, p=p).argmin(1), reps=3, warmup=1))
        # the record keeps K7's sqrt branch (p=1.5); the exp/log branch
        # (p=2.7) is printed
        if key not in timings:
            timings[key] = t
            bounds[key] = bounds_of(p, xt_, wt_)
        print(f"time {label} flagship: kernel {t[0]:.4f} ms (the samples' layout included, "
              f"the codebook laid out once), plain {t[1]:.4f} ms, library (cdist p={p} + "
              f"argmin) {t[2]:.4f} ms; bound {bounds_of(p, xt_, wt_)[0]:.4f} ms (CUDA events; "
              f"{card})")
    return timings, errs, bounds


def bounds_of(p, x, w):
    """The elementwise searches' bound at (x, w): issue and special-function
    time of the terms (_elementwise_seconds) against the operands' bytes."""
    return bound(_elementwise_seconds(p, x.shape[0], w.shape[0], x.shape[1]),
                 4 * (x.numel() + w.numel()) + 8 * x.shape[0])


def _check_engine_fixtures(torch):
    """The elementwise engine (csrc/tile_argmin.cuh) on fixtures that reach
    each of its paths: K5 and K6 (p = 3) bit for bit against their plain
    versions, K7 (p = 1.5, 2.7) within its contract. Integer-valued data in
    {0, 1, 2} at D = 8 ties exactly almost everywhere: on the flagship
    chunk (one codebook segment) the first index must survive ties across
    tiles and pipeline stages (one chunk a stage), at 1000 x 2100 (17
    segments) across segments and their merge. Returns the largest value
    error of each kernel."""
    from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke
    from xpysom_dask_tpu_torch.ops.kernels.stats import _sm_count
    from xpysom_dask_tpu_torch.ops.kernels.tile import tile_plan

    rng = np.random.RandomState(11)
    xi = rng.randint(0, 3, (16384, 8)).astype(np.float32)
    wi = rng.randint(0, 3, (16384, 8)).astype(np.float32)
    fixtures = (
        ("integer ties 16384x16384 D=8", xi, wi),
        ("integer ties 1000x2100 D=8", xi[:1000], wi[:2100]),
        ("n=5 below one block, 300 nodes", rng.rand(5, 7), rng.rand(300, 7)),
        ("xy=50 below one tile, 1000 rows", rng.rand(1000, 9), rng.rand(50, 9)),
        ("D=1 3000x700", rng.rand(3000, 1), rng.rand(700, 1)),
        ("D=512 (d-slabs) 2048x2048", rng.rand(2048, 512), rng.rand(2048, 512)),
    )
    errs = {"bmu_manhattan": 0.0, "bmu_norm_p_odd": 0.0, "bmu_norm_p_frac": 0.0}
    for label, x, w in fixtures:
        x, w = x.astype(np.float32), w.astype(np.float32)
        segs = tile_plan(x.shape[0], w.shape[0], _sm_count(0))[1]
        label = f"{label}, {segs} segment{'s' if segs > 1 else ''}"
        compare_tile(torch, f"K5 {label}", ke.bmu_manhattan, ke.bmu_manhattan_plain, x, w,
                     exact=True)
        compare_tile(torch, f"K6 p=3 {label}", ke.bmu_norm_p_odd, ke.bmu_norm_p_odd_plain, x, w,
                     3, exact=True)
        for p in (1.5, 2.7):
            errs["bmu_norm_p_frac"] = max(errs["bmu_norm_p_frac"],
                                          _compare_frac(torch, f"K7 p={p} {label}", x, w, p)[0])
    return errs


def _frac_term_sweep(torch, card):
    """K7's term t^p on the card against float64, over 2^20 uniform t in
    [0, 1) and 2^20 log-uniform t in [2^-149, 2^127], through the search
    itself (D = 1 against the codebook row 0, so the value is the term);
    the plain version's term beside it. Requires the kernel within
    FRAC_RTOL of the plain version wherever the result is a normal f32,
    0 at t = 0, 1 at t = 1 and +inf at t = +inf. Returns the largest
    relative error against float64."""
    from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke

    t = np.concatenate([np.random.RandomState(9).rand(1 << 20),
                        2.0 ** np.random.RandomState(10).uniform(-149, 127, 1 << 20),
                        [0.0, 1.0, np.inf]]).astype(np.float32)
    xs = torch.from_numpy(t[:, None]).cuda()
    zero = torch.zeros((1, 1), device="cuda")
    worst = 0.0
    for p in (0.3, 0.5, 1.5, 2.5, 2.7, 3.3):
        got, want = (fn(xs, zero, p)[1].cpu().numpy() for fn in
                     (ke.bmu_norm_p_frac, ke.bmu_norm_p_frac_plain))
        require(got[-3] == 0.0 and got[-2] == 1.0 and got[-1] == np.inf,
                f"K7 p={p}: t = 0, 1, inf give {got[-3:]}")
        with np.errstate(over="ignore"):
            exact = t[:-3].astype(np.float64) ** p
        normal = (exact >= 2.0**-126) & (exact <= np.finfo(np.float32).max)
        g, w_, e = got[:-3][normal].astype(np.float64), want[:-3][normal], exact[normal]
        rel_k, rel_p = np.abs(g - e) / e, np.abs(w_ - e) / e
        rel_kp = np.abs(g - w_) / w_
        below = exact < 2.0**-126
        tiny = np.abs(got[:-3][below] - exact[below]).max(initial=0.0)
        require(rel_kp.max() <= FRAC_RTOL, f"K7 p={p}: term off the plain version's by "
                f"{rel_kp.max():.3g} relative")
        worst = max(worst, float(rel_k.max()))
        print(f"K7 term sweep p={p} ({len(t) - 3} values of t): largest relative error against "
              f"float64 {rel_k.max():.3g} (plain version {rel_p.max():.3g}; kernel against plain "
              f"{rel_kp.max():.3g}); results below 2^-126 off by at most {tiny:.3g} ({card})")
    return worst


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
    err, first = 0.0, None
    for kern, plain in pairs:
        got, want = kern(*ops), plain(*ops)
        torch.cuda.synchronize()
        if first is None:
            first = got
        else:  # K2: its first place is K1's, bit for bit
            require(_bits_equal(torch, got[:2], first), f"{name}: K2's first place is not K1's")
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
    n, k = o3[0].shape
    xy = o3[5]
    laid3 = kb.PackedCodebook(torch.from_numpy(w).cuda(), "split3").laid()
    once = kb.bmu_split3(*o3, w_laid=laid3)
    for again in (kb.bmu_split3(*o3), kb.PackedCodebook(torch.from_numpy(w).cuda(), "split3")
                  .argmin(torch.from_numpy(x).cuda())):
        require(torch.equal(once[0], again[0]) and torch.equal(
            once[1].view(torch.int32), again[1].view(torch.int32)),
            "split3 flagship: K3 launches (codebook laid out once / per call, samples "
            "packed in one pass) differ in bits")
    mm_f32, mm_label = _mm_f32(torch)
    xh, xl, wh, wl, w_sq, _ = o3

    def library():
        cross = (mm_f32(xh, wh[:, :xy]) + mm_f32(xh, wl[:, :xy])) + mm_f32(xl, wh[:, :xy])
        return (-2.0 * cross + w_sq[None, :xy]).argmin(1)

    timings["bmu_split3"] = (cuda_ms(torch, lambda: kb.bmu_split3(*o3, w_laid=laid3)),
                             cuda_ms(torch, lambda: kb.bmu_split3_plain(*o3)),
                             cuda_ms(torch, library))
    x_laid = [kb.lay_out(t, kb.GEMM_BM) for t in (xh, xl)]
    for label, resident in (("A resident", True), ("A streamed", False)):
        ms = cuda_ms(torch, lambda: kb._gemm_sm90("xps_gemm_split3", (*x_laid, *laid3, w_sq), n,
                                                  k, xy, resident))
        print(f"time bmu_split3 (K3) at the flagship chunk, its kernel alone, {label}: "
              f"{ms:.4f} ms (CUDA events; {card})")
    bounds["bmu_split3"] = bound(3 * 2.0 * n * xy * k / BF16_FLOPS,
                                 2 * 2 * (n * k + k * o3[2].shape[1]) + 4 * xy + 8 * n)
    errs["bmu_split3"] = errs.pop("split3")
    print(f"time bmu_split3 (K3) at the flagship chunk: kernel {timings['bmu_split3'][0]:.4f} "
          f"ms, plain {timings['bmu_split3'][1]:.4f} ms, library (three bf16 cuBLAS products, "
          f"{mm_label}, summed (hh + hl) + lh, -2 cross + w_sq, argmin; a composition of "
          f"calls) {timings['bmu_split3'][2]:.4f} ms (CUDA events; {card})")
    for mode in ("bf16", "split2"):
        a, w_aug, xy = ops[mode]
        laid = kb.PackedCodebook(torch.from_numpy(w).cuda(), mode).laid()[0]
        t1 = (cuda_ms(torch, lambda: kb.bmu_argmin(a, w_aug, xy, w_laid=laid)),
              cuda_ms(torch, lambda: kb.bmu_argmin_plain(a, w_aug, xy)))
        b = bound(2.0 * a.shape[0] * xy * a.shape[1] / BF16_FLOPS, 0)[0]
        print(f"time bmu_argmin (K1) under {mode} operands (K={a.shape[1]}) at the flagship "
              f"chunk: kernel {t1[0]:.4f} ms, plain {t1[1]:.4f} ms, bound {b:.4f} ms "
              f"(CUDA events; {card})")
        if mode == "bf16":
            t2 = (cuda_ms(torch, lambda: kb.bmu_top2(a, w_aug, xy, w_laid=laid)),
                  cuda_ms(torch, lambda: kb.bmu_top2_plain(a, w_aug, xy)),
                  cuda_ms(torch, lambda: torch.topk(mm_f32(a, w_aug[:, :xy]), 2, dim=1,
                                                    largest=False)))
            print(f"time bmu_top2 (K2) under bf16 operands at the flagship chunk: kernel "
                  f"{t2[0]:.4f} ms, plain {t2[1]:.4f} ms, library ({mm_label}, + topk(2)) "
                  f"{t2[2]:.4f} ms, bound {b:.4f} ms (CUDA events; {card})")

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
    return counts


def phase_manhattan_epoch(torch, card, tree="this tree"):
    """The manhattan epoch of ``XPySom(128, 128, 64,
    activation_distance='manhattan', random_seed=0)`` on the manhattan
    path's 2^19 samples, device-resident, from the initial codebook (one
    unmeasured epoch, then three between synchronizations); returns the
    median in ms."""
    from xpysom_dask_tpu_torch import XPySom

    f = FLAGSHIP
    data = np.random.RandomState(3).rand(f["n"], f["d"]).astype(np.float32)
    som = XPySom(f["x"], f["y"], f["d"], sigma=64, sigmaN=1, learning_rate=0.5,
                 learning_rateN=0.01, random_seed=0, activation_distance="manhattan")
    return 1e3 * _epoch_times(torch, f"manhattan ({tree}; {card})", som, data)


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
    laid_p = packed.laid()[0]
    t = {
        "margin search": cuda_ms(torch, lambda: cb.argmin(xt)),
        "its operands (centering, bf16 packing)": cuda_ms(torch, lambda: cb.operands(xt)),
        "K2 on bf16 operands (codebook laid out once, as the search runs it)": cuda_ms(
            torch, lambda: kb.bmu_top2(*ops, w_laid=cb.laid()[1])),
        "the rescue after K2 (gate, host read, compaction, packing, K1 over the buffer, "
        "scatter, exact values)": cuda_ms(torch, lambda: kb.margin_rescue(
            i_b, v_b, v2_b, xc, cb.w, cb.w_sq, cb.w_aug_packed, kb.bmu_argmin)),
        "gate": cuda_ms(torch, lambda: kb.margin_suspects(v_b, v2_b, xc, cb.w)),
        f"packed K1 over the {cap}-row buffer": cuda_ms(
            torch, lambda: kb.bmu_argmin(a_buf, w_aug_p, xy, w_laid=laid_p)),
        f"packed K1 over all {n} rows": cuda_ms(
            torch, lambda: kb.bmu_argmin(a_p, w_aug_p, xy, w_laid=laid_p)),
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


def _check_kb_padding(torch, kb, name, ops, kblock, got):
    """K1-kb on ``ops`` zero-padded to a multiple of ``kblock`` (as the
    plain version pads) gives ``got``, its output on the unpadded
    operands, bit for bit in idx and val."""
    a, w_aug, xy = ops
    pa, pw = kb._pad_k(a, w_aug, kblock)
    padded = kb.bmu_argmin_kb(pa, pw, xy, kblock)
    torch.cuda.synchronize()
    require(_bits_equal(torch, got, padded),
            f"{name}: K1-kb on unpadded operands differs from K1-kb on padded ones")
    print(f"{name} kblock={kblock}: K1-kb on unpadded operands (K = {a.shape[1]}) equals K1-kb "
          f"on operands padded to K = {pa.shape[1]} bit for bit")


def phase_kblock(torch, card):
    """The wide-D search through ``PackedCodebook.argmin(kblock=)`` at the
    shapes of tools/r4_kblock.py, modes packed and bf16, kblock 512 and
    1024 (the counters read around those calls); then K1-kb against its
    plain version and K1 on the same operands, on unpadded operands bit
    for bit its output on operands zero-padded to kblock, a ragged shape,
    a tie fixture across slabs, the validation errors, and CUDA-event
    timings beside K1 and one bf16 ``mm`` + ``argmin`` over the whole K.
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
    mm_f32, mm_label = _mm_f32(torch)
    for (shape, mode, kbk) in cases:
        n, xy, d = shape
        x, w = data[shape]
        cb = cbs[(shape, mode)]
        ops = cb.operands(dev[shape][0])
        a, w_aug, _ = ops
        i_k, v_k = out[(shape, mode, kbk)]
        i_p, v_p = kb.bmu_argmin_kb_plain(*ops, kbk)
        laid = cb.laid()[0]
        i_1, v_1 = kb.bmu_argmin(*ops, w_laid=laid)
        if (shape, kbk) == (WIDE_SHAPES[0], 512):
            _check_kb_padding(torch, kb, f"K1-kb {mode} {n}x{xy} D={d}", ops, kbk, (i_k, v_k))
        if kbk == 512:  # K1 against its own plain version, once per shape and mode
            i_1p, v_1p = kb.bmu_argmin_plain(*ops)
            d1 = np.nonzero((i_1 != i_1p).cpu().numpy())[0]
            _kb_flips(f"K1 {mode} {n}x{xy} D={d} vs plain", d1, mode,
                      (x - cb.center.cpu().numpy()).astype(np.float64),
                      (w - cb.center.cpu().numpy()).astype(np.float64), a, w_aug,
                      i_1.cpu().numpy(), i_1p.cpu().numpy())
            same1 = i_1 == i_1p
            e1 = float((v_1 - v_1p).abs()[same1].max())
            print(f"K1 {mode} {n}x{xy} D={d} (K = {a.shape[1]}): {len(d1)} tie index "
                  f"differences against its plain version, max|dv| {e1:.3g}")
            del i_1p, v_1p
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
        t = (cuda_ms(torch, lambda: kb.bmu_argmin_kb(*ops, kbk, w_laid=laid)),
             cuda_ms(torch, lambda: kb.bmu_argmin(*ops, w_laid=laid)),
             cuda_ms(torch, lambda: kb.bmu_argmin_kb_plain(*ops, kbk), reps=3, warmup=1),
             cuda_ms(torch, lambda: mm_f32(a, w_aug[:, :xy]).argmin(1)))
        k = a.shape[1]
        b = bound(2.0 * n * xy * k / BF16_FLOPS, 2 * (n * k + k * w_aug.shape[1]) + 8 * n)
        print(f"time {name} (K = {k}, not padded; the plain version pads to "
              f"{-(-k // kbk) * kbk}): K1-kb {t[0]:.4f} ms, K1 {t[1]:.4f} ms "
              f"(K1-kb / K1 {t[0] / t[1]:.3f}), plain {t[2]:.4f} ms, library (one bf16 cuBLAS "
              f"product, {mm_label}, + argmin over the whole K) {t[3]:.4f} ms, bound "
              f"{b[0]:.4f} ms by {b[1]}; max|dv| {e:.3g} (CUDA events; {card})")
        if record is None:
            record = ((t[0], t[2], t[3]), b)
        del i_p, v_p

    # ragged: K = 3·200 + 3 = 603 in five 128-deep slabs, 91 nodes
    xr = rng.rand(1000, 200).astype(np.float32)
    wr = (rng.rand(91, 200) * 2 - 1).astype(np.float32)
    for mode in ("packed", "bf16"):
        cb = kb.PackedCodebook(torch.from_numpy(wr).cuda(), mode)
        ops = cb.operands(torch.from_numpy(xr).cuda())
        i_k, v_k = cb.argmin(torch.from_numpy(xr).cuda(), kblock=128)
        _check_kb_padding(torch, kb, f"K1-kb {mode} ragged 1000x91 D=200", ops, 128, (i_k, v_k))
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
    the codebook and the longest run."""
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
    first chunk and on n = 65536, 20000 and 40000 nodes and D = 200, with
    per-chunk times, K10's kernel alone against K1's beside K9's device
    time, torch.profiler device times by kernel, and per-epoch times.
    Returns the launches, the error, the record's timings and bound."""
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
    # the kernel's loops: 512 row blocks on 132 SMs (the persistent search
    # wraps, on a fresh ring per row block); 200 x 100 nodes; 200 x 200
    # nodes (313 ranges of 128: some groups of 256 threads take two); D =
    # 200 (two column passes, 373 ranges of 44 nodes, K = 603)
    for label, (n_, xy_, d_) in (("n = 65536 (512 row blocks)", (65536, xy, d)),
                                 ("200 x 100 = 20000 nodes", (f["chunk"], 20000, d)),
                                 ("200 x 200 = 40000 nodes", (f["chunk"], 40000, d)),
                                 ("D = 200", (f["chunk"], xy, 200))):
        plan = kf.fused_plan(n_, xy_, d_, torch.cuda.get_device_properties(0).multi_processor_count)
        _fused_vs_k1_k9(torch, f"K10 {label}, plan {tuple(plan)}",
                        torch.from_numpy(rng.rand(n_, d_).astype(np.float32)).cuda(),
                        torch.from_numpy((rng.rand(xy_, d_) * 2 - 1).astype(np.float32)).cuda(),
                        torch.from_numpy((rng.rand(n_) > 0.05).astype(np.float32)).cuda())

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
        # as epoch_stats runs them: K1 on the codebook laid out once and the
        # samples packed and laid out in one pass, the operands K10 reads
        i, _ = cb.argmin(x)
        return ks.scatter_stats(x, m, i, xy)

    def k1_k9_operands(cb, x, m):
        # the earlier yardstick: K1 through bmu_argmin on the packed operands,
        # laying the codebook out in the call
        i, _ = kb.bmu_argmin(*cb.operands(x))
        return ks.scatter_stats(x, m, i, xy)

    timings = {}
    for label, (cb, x, m) in (("uniform", (cb_u, xu, mu)),
                              (f"skewed (longest run {run})", (cb_s, chunks[0], mask[0]))):
        i, _ = cb.argmin(x)
        t = (cuda_ms(torch, lambda: kf.bmu_stats_fused(x, cb, m)),
             cuda_ms(torch, lambda: kf.bmu_stats_fused_plain(x, cb, m), reps=3, warmup=1),
             cuda_ms(torch, lambda: k1_k9(cb, x, m)),
             cuda_ms(torch, lambda: cb.argmin(x)),
             cuda_ms(torch, lambda: ks.scatter_stats(x, m, i, xy)),
             cuda_ms(torch, lambda: k1_k9_operands(cb, x, m)),
             cuda_ms(torch, lambda: kf.bmu_stats_fused(x, cb, m)))
        timings[label] = t
        print(f"time K10 {label} chunk (each with the samples' packing): fused {t[0]:.4f} and "
              f"{t[6]:.4f} ms, plain {t[1]:.4f} ms, K1 + K9 {t[2]:.4f} ms ({t[0] / t[2]:.3f}x), "
              f"of which K1 {t[3]:.4f} ms and K9 {t[4]:.4f} ms; K1 + K9 through bmu_argmin on "
              f"the packed operands {t[5]:.4f} ms (CUDA events; {card})")
        # the phase split: the kernels alone on laid-out operands, back to
        # back (so the events see device time), K10's against K1's, beside
        # K9's device time; then torch.profiler's device times by kernel
        a_l = kb.lay_out_samples(x, None, "packed")
        n_ = x.shape[0]
        k10_ms = cuda_ms(torch, lambda: kf._launch_k10(a_l, cb.laid()[0], n_, 3 * d + 3, xy, x, m))
        k1_ms = cuda_ms(torch, lambda: kb._launch_k1(a_l, cb.laid()[0], n_, 3 * d + 3, xy))
        parts = _profile_kernels(torch, lambda: k1_k9(cb, x, m),
                                 ("gemm_sm90_kernel", "scatter_stats_kernel"))
        k9_ms = parts["scatter_stats_kernel"] / 1e3 if parts else float("nan")
        print(f"phase split K10 {label} chunk, the kernels alone on laid-out operands: K10 "
              f"{k10_ms:.4f} ms, K1 {k1_ms:.4f} ms; phase 2, the grid barrier and what phase 1 "
              f"costs beyond K1 take {k10_ms - k1_ms:.4f} ms against K9's {k9_ms:.4f} ms of "
              f"device time (CUDA events; torch.profiler for K9; {card})")
        split_k10 = _profile_kernels(torch, lambda: kf.bmu_stats_fused(x, cb, m),
                                     ("fused_stats_kernel",))
        # CUPTI's record of the cooperative launch has come back empty or
        # short of the events' time on this card: printed, not used
        print(f"profile K10 {label} chunk: device us by kernel {split_k10 or 'not captured'}; "
              f"K1 + K9 {parts or 'not captured'} (torch.profiler, one call; {card})")
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


# the streamed flagship: 2^22 + 12288 rows, so an epoch is four full
# superbatches of default_superbatch_rows(64) = 2^20 rows and a ragged fifth
# of 12288 (a multiple of the 16384-row chunk's 1024-row alignment)
STREAM_N = (1 << 22) + 12288
# the manhattan streamed run: 2^16 rows in superbatches of 2^14, one epoch
L1_STREAM_N, L1_STREAM_ROWS = 1 << 16, 1 << 14


def _flagship_rows(n, d):
    """``RandomState(0).rand(n, d)`` as float32, drawn 2^20 rows at a time
    (the same stream as one draw, without its float64 copy of the whole)."""
    rs = np.random.RandomState(0)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, 1 << 20):
        out[s:s + (1 << 20)] = rs.rand(min(1 << 20, n - s), d)
    return out


def _busy_share(torch, prof, wall_s):
    """Device busy share of a profiled window: the union of the device
    intervals of every event (kernels and copies), of the kernels alone and
    of the copies alone, each over the window's host wall time."""
    def union(iv):
        busy, cur_s, cur_e = 0, None, None
        for s, e in sorted(iv):
            if cur_e is None or s > cur_e:
                busy += 0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return busy + (0 if cur_e is None else cur_e - cur_s)

    # the program's spans (``annotate``) appear as device-side user
    # annotations that cover whole calls: they are not device work
    dev = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)]
    copies = [(e.time_range.start, e.time_range.end) for e in dev if e.name.startswith("Memcpy")]
    kernels = [(e.time_range.start, e.time_range.end) for e in dev
               if not e.name.startswith(("Memcpy", "Memset"))]
    wall_us = wall_s * 1e6
    return {"busy": union(copies + kernels) / wall_us, "kernels": union(kernels) / wall_us,
            "copies": union(copies) / wall_us, "events": len(dev)}


def _read_rate(src, rows, path, cold):
    """MB/s of one pass of ``src.superbatches(rows)`` (disk or page cache to
    host arrays); ``cold`` first drops the file's pages from the page cache
    (``posix_fadvise(DONTNEED)``, the file was synced when written)."""
    if cold:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    t0 = time.perf_counter()
    nbytes = sum(block.nbytes for block in src.superbatches(rows))
    took = time.perf_counter() - t0
    require(nbytes == os.path.getsize(path), f"the loader read {nbytes} bytes of the file")
    return nbytes / took / 1e6, took


def phase_streaming(torch, card, workdir):
    """The flagship trained and scored out of core: ``XPySom(128, 128, 64)``
    on STREAM_N rows read from a file through ``FileSource`` (the native
    loader), two epochs streamed against two resident, bitwise; streamed
    ``predict``/``activation_response`` bitwise and QE/TE within the
    summation-order tolerance of the resident ones; the loader's read rate,
    the epoch times and the device busy share of a streamed epoch; then a
    short streamed manhattan run (K5) bitwise against its resident run.
    Returns the launch counts of the streamed path."""
    from xpysom_dask_tpu_torch import XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import (ArraySource, FileSource, default_superbatch_rows,
                                                device_superbatches)
    from torch.profiler import ProfilerActivity, profile

    f = FLAGSHIP
    kw = dict(sigma=64, sigmaN=1, learning_rate=0.5, learning_rateN=0.01, random_seed=0)
    rows = default_superbatch_rows(f["d"])
    require(rows == 1 << 20, f"default superbatch {rows} rows, not 2^20")
    t0 = time.perf_counter()
    data = _flagship_rows(STREAM_N, f["d"])
    path = os.path.join(workdir, "stream.f32")
    t1 = time.perf_counter()
    with open(path, "wb") as fh:
        data.tofile(fh)
        fh.flush()
        os.fsync(fh.fileno())
    t2 = time.perf_counter()
    print(f"streaming: {STREAM_N} x {f['d']} rows drawn in {t1 - t0:.3f} s, written and synced "
          f"({data.nbytes / 1e6:.1f} MB) in {t2 - t1:.3f} s = {data.nbytes / (t2 - t1) / 1e6:.1f} MB/s")
    src = FileSource(path, STREAM_N, f["d"])
    require(src._lib is not None, "the native chunk loader did not build (g++) or load")
    cold, cold_s = _read_rate(src, rows, path, cold=True)
    warm, warm_s = _read_rate(src, rows, path, cold=False)
    print(f"loader (FileSource, native, {src.n_buffers} buffers, superbatches of {rows} rows) "
          f"disk to host: {cold:.1f} MB/s after dropping the file's pages ({cold_s:.3f} s), "
          f"{warm:.1f} MB/s from the page cache ({warm_s:.3f} s) ({card})")
    # the feed alone: the loader, the pinned ring's fill and the uploads on
    # the side stream, no kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = sum(n for _, _, n in device_superbatches(src, rows, f["chunk"], torch.device("cuda")))
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    require(fed == STREAM_N, f"the feed delivered {fed} rows")
    print(f"feed alone (loader, pinned ring, side stream; no kernel): {feed_s * 1e3:.3f} ms "
          f"for {STREAM_N} rows = {data.nbytes / feed_s / 1e6:.1f} MB/s ({card})")

    kernels.reset_launch_counts()
    streamed = XPySom(f["x"], f["y"], f["d"], **kw)
    stream_s = []
    for e in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamed.train(src, 2, iter_beg=e, iter_end=e + 1)
        torch.cuda.synchronize()
        stream_s.append(time.perf_counter() - t0)
    scored = {}
    for name in ("predict", "quantization_error", "topographic_error", "activation_response"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored[name] = getattr(streamed, name)(src)
        scored[name + "_s"] = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"streaming path launch counts: {counts}")

    resident = XPySom(f["x"], f["y"], f["d"], **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resident.train(data, 2)
    torch.cuda.synchronize()
    resident_call_s = time.perf_counter() - t0
    ws, wr = streamed.get_weights(), resident.get_weights()
    require(ws.shape == wr.shape and np.isfinite(ws).all(), "streamed codebook malformed")
    require(np.array_equal(ws.view(np.int32), wr.view(np.int32)),
            f"streamed training differs from resident training in bits: "
            f"max|dw| {np.abs(ws - wr).max()}")
    print(f"streaming: 2 streamed epochs bitwise equal to 2 resident epochs over {STREAM_N} rows")
    n_chunks = -(-STREAM_N // f["chunk"])
    for name, need in (("bmu_argmin", 5 * n_chunks), ("scatter_stats", 2 * n_chunks),
                       ("bmu_top2", n_chunks)):
        require(counts[name] >= need, f"streaming: {name} launched {counts[name]} < {need} times")

    res = {}
    for name in ("predict", "quantization_error", "topographic_error", "activation_response"):
        t0 = time.perf_counter()
        res[name] = getattr(resident, name)(data)
        res[name + "_s"] = time.perf_counter() - t0
    require(np.array_equal(scored["predict"], res["predict"]), "streamed predict differs")
    require(np.array_equal(scored["activation_response"], res["activation_response"]),
            "streamed activation_response differs")
    require(scored["activation_response"].sum() == STREAM_N, "activation_response lost rows")
    # the resident sums fold n_chunks f32 chunk partials; the streamed ones
    # fold fewer per superbatch and the superbatches in float64: the two
    # differ by at most the f32 recursive-sum bound (n_chunks - 1) * 2^-24
    tol = (n_chunks - 1) * F32_U
    for name in ("quantization_error", "topographic_error"):
        a, b = scored[name], res[name]
        require(np.isfinite(a) and abs(a - b) <= tol * abs(b),
                f"streamed {name} {a!r} differs from resident {b!r} beyond {tol:.3g} relative")
    print(f"streaming scoring: predict and activation_response bitwise equal to resident; "
          f"QE {scored['quantization_error']!r} vs {res['quantization_error']!r}, "
          f"TE {scored['topographic_error']!r} vs {res['topographic_error']!r} "
          f"(tolerance {tol:.3g} relative)")
    print("streaming scoring times (host clock, s): " + ", ".join(
        f"{k} streamed {scored[k + '_s']:.3f} resident {res[k + '_s']:.3f}"
        for k in ("predict", "quantization_error", "topographic_error", "activation_response"))
        + f" ({card})")

    # the resident epoch on device-resident chunks (no upload), beside the
    # streamed epochs and the resident call (chunking and upload included)
    chunks, mask, _ = resident._chunked(data)
    step = core.make_epoch_step(resident._spec, 2)
    w = resident._device_weights()
    step(w, chunks, mask, 1)
    dev_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(w, chunks, mask, 1)
        torch.cuda.synchronize()
        dev_s.append(time.perf_counter() - t0)
    del chunks, mask
    print(f"streaming epochs over {STREAM_N} rows (host clock, synchronized): streamed "
          f"{[round(t * 1e3, 3) for t in stream_s]} ms = "
          f"{STREAM_N / min(stream_s) / 1e6:.3f} M samples/s at best; resident on device-resident "
          f"chunks {[round(t * 1e3, 3) for t in dev_s]} ms (median "
          f"{sorted(dev_s)[1] * 1e3:.3f}); resident train(data, 2) call {resident_call_s:.3f} s "
          f"(chunking and upload included) ({card})")

    probe = XPySom.from_numpy(ws, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probe.train(src, 3, iter_beg=2, iter_end=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    share = _busy_share(torch, prof, wall)
    require(share["events"] > 0, "torch.profiler saw no device event in the streamed epoch")
    print(f"streamed epoch under torch.profiler: {wall * 1e3:.3f} ms; device busy "
          f"{share['busy']:.4f} of it (kernels {share['kernels']:.4f}, host-to-device copies "
          f"{share['copies']:.4f}; {share['events']} device events) ({card})")

    # manhattan: K5 streamed, superbatches of one chunk
    l1 = dict(kw, activation_distance="manhattan")
    part = data[:L1_STREAM_N]
    del data
    kernels.reset_launch_counts()
    s1 = XPySom(f["x"], f["y"], f["d"], **l1)
    require(s1._n_parallel == L1_STREAM_ROWS, f"manhattan chunk {s1._n_parallel}")
    s1._superbatch_rows = lambda: L1_STREAM_ROWS
    s1.train(ArraySource(part), 1)
    c1 = kernels.launch_counts()
    r1 = XPySom(f["x"], f["y"], f["d"], **l1).train(part, 1)
    require(c1["bmu_manhattan"] >= L1_STREAM_N // L1_STREAM_ROWS, "streamed manhattan: K5 not "
            f"launched ({c1['bmu_manhattan']})")
    require(np.array_equal(s1.get_weights().view(np.int32), r1.get_weights().view(np.int32)),
            "streamed manhattan epoch differs from the resident one in bits")
    print(f"streamed manhattan: 1 epoch over {L1_STREAM_N} rows in superbatches of "
          f"{L1_STREAM_ROWS}, bitwise equal to resident; K5 launches {c1['bmu_manhattan']}")
    os.remove(path)
    return counts


def phase_checkpoint_and_pickle(torch, card, data, kw, workdir):
    """Checkpoint and resume on the card: the flagship on the main path's
    2^19 rows, 4 epochs of a 4-epoch schedule uninterrupted, against a run
    that writes a checkpoint every 2 epochs and stops after 2, then
    ``load_checkpoint`` and ``train(iter_beg=_checkpoint_epoch)``: bitwise.
    Then a card-trained model through ``pickle``: its winners on 4096 rows
    unchanged; and ``autotune_kernel`` (K1 at the training chunk). Returns
    the launch counts of the resume."""
    import pickle

    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    f = FLAGSHIP
    path = os.path.join(workdir, "flagship.npz")
    full = XPySom(f["x"], f["y"], f["d"], **kw).train(data, 4)
    cut = XPySom(f["x"], f["y"], f["d"], **kw)
    cut.train(data, 4, iter_end=2, checkpoint_path=path, checkpoint_every=2)
    resumed = XPySom.load_checkpoint(path)
    require(resumed._checkpoint_epoch == 2, f"checkpoint epoch {resumed._checkpoint_epoch}")
    require(resumed._device.type == "cuda", f"resumed on {resumed._device}")
    require(np.array_equal(resumed.get_weights(), cut.get_weights()), "checkpoint weights differ")
    kernels.reset_launch_counts()
    resumed.train(data, 4, iter_beg=resumed._checkpoint_epoch)
    counts = kernels.launch_counts()
    require(counts["bmu_argmin"] >= 2 * (f["n"] // f["chunk"]) and counts["scatter_stats"] >= 1,
            f"resume: K1/K9 launches {counts}")
    wf, wr = full.get_weights(), resumed.get_weights()
    require(np.array_equal(wf.view(np.int32), wr.view(np.int32)),
            f"resumed codebook differs from the uninterrupted run: max|dw| {np.abs(wf - wr).max()}")
    print(f"checkpoint: epochs 0-1, checkpoint, load_checkpoint, epochs 2-3 bitwise equal to 4 "
          f"uninterrupted epochs; resume launches K1 {counts['bmu_argmin']}, K9 "
          f"{counts['scatter_stats']}")

    blob = pickle.dumps(full)
    back = pickle.loads(blob)
    require(back._device.type == "cuda", f"unpickled on {back._device}")
    win, win_back = full.winner(data[:4096]), back.winner(data[:4096])
    require(win == win_back, "winners changed through pickle")
    print(f"pickle: {len(blob)} bytes; winners on 4096 rows unchanged after the round trip")
    res = full.autotune_kernel()
    require(res is not None and res.tiles is None and np.isfinite(res.timings_ms[None]),
            f"autotune_kernel returned {res}")
    print(f"autotune_kernel: the training search at the {f['chunk']}-row chunk "
          f"{res.timings_ms[None]:.4f} ms a call (CUDA events), first call "
          f"{res.first_call_s[None]:.4f} s ({card})")
    return counts


# The population phase's two sweeps, neither cut: the JAX package's own
# population measurement (tools/r5_population_fused.py:64-70: P = 16 maps of
# 24 x 24 x 16 on 2^17 rows of RandomState(0).rand, sigma=2.0,
# random_seed=1; 9,216 stacked nodes) and four of the flagship's maps on
# its 2^19 rows (member 0 is the flagship run itself; 65,536 stacked
# nodes). ``rows``: the streamed superbatch, a multiple of every chunk.
POP_SWEEPS = (
    dict(name="sweep", p=16, x=24, y=24, d=16, n=1 << 17, rows=1 << 15,
         kw=dict(sigma=2.0, random_seed=1)),
    dict(name="flagship sweep", p=4, x=128, y=128, d=64, n=1 << 19, rows=1 << 17,
         kw=dict(sigma=[64, 48, 32, 16], sigmaN=1, learning_rate=0.5, learning_rateN=0.01,
                 random_seed=0)),
)


def _member_kw(cfg, i):
    """The lone ``XPySom`` knobs of member ``i`` of a sweep."""
    kw = dict(cfg["kw"])
    kw["random_seed"] = kw["random_seed"] + i
    kw["sigma"] = kw["sigma"][i] if isinstance(kw["sigma"], list) else kw["sigma"]
    return kw


def _pop_winners(pop, w, data):
    """(P, N) winners of every member of the stacked (P, X, Y, D) host
    codebooks ``w`` by the concatenated fp32 search of strategy
    'batched', over the population's chunks."""
    import torch

    from xpysom_dask_tpu_torch.models import population as pm

    dist = pop._members_list[0]._spec.distance_fn()
    chunks, _, n = pop.member(0)._chunked(data, pop._n_parallel)
    w_big = torch.from_numpy(np.ascontiguousarray(w.reshape(-1, w.shape[-1]))).to(chunks.device)
    w_sq = torch.sum(w_big * w_big, dim=1, keepdim=True)
    out = [pm._block_argmin(dist.flat, chunks[c], w_big, w_sq, w.shape[0])
           for c in range(chunks.shape[0])]
    return torch.cat(out, dim=1)[:, :n].cpu().numpy()


def _search_flips(name, data, w_flat, got, want):
    """Rows where two searches of ``data`` against the (XY, D) codebook
    ``w_flat`` chose different winners, each held to the two searches'
    stated error floors: the packed split's 2^-17 * sum_d |xc_d||2 wc_d| on
    operands centered on the codebook mean, plus an f32 dot product's
    D * 2^-24 * (sum_d |x_d||2 w_d| + |w|^2). Prints the flips with their
    float64 margins; returns how many lie outside."""
    rows = np.nonzero(got != want)[0]
    if not len(rows):
        return 0
    x = data[rows].astype(np.float64)
    w64 = w_flat.astype(np.float64)
    center = w_flat.mean(0, dtype=np.float32).astype(np.float64)
    wa, wb = w64[got[rows]], w64[want[rows]]
    gap = np.abs(((x - wa) ** 2).sum(1) - ((x - wb) ** 2).sum(1))

    def band(wc):
        packed = NEAR_TIE * (np.abs(x - center) * np.abs(2 * (wc - center))).sum(1)
        f32 = x.shape[1] * F32_U * ((np.abs(x) * np.abs(2 * wc)).sum(1) + (wc * wc).sum(1))
        return packed + f32

    floor = np.maximum(band(wa), band(wb))
    bad = int((gap > floor).sum())
    worst = float((gap / floor).max())
    print(f"{name}: {len(rows)} winner flips of {len(data)} rows; float64 margins "
          f"{np.array2string(gap[:8], precision=3)}{' ...' if len(rows) > 8 else ''}, "
          f"largest margin / floor {worst:.3g}; {bad} outside the floors")
    return bad


def _held_epoch(name, got, want, flips):
    """An epoch ``got`` against ``want`` (the same start) within the epochs
    tolerance, or, where it is not, every winner flip of that epoch's
    searches within the searches' error floors (``flips()`` returns the
    count outside)."""
    dw = float(np.abs(got - want).max())
    if np.allclose(got, want, rtol=EPOCH_RTOL, atol=EPOCH_ATOL):
        print(f"{name}: max|dw| {dw:.3g} within rtol {EPOCH_RTOL}, atol {EPOCH_ATOL}")
        return
    print(f"{name}: max|dw| {dw:.3g} beyond rtol {EPOCH_RTOL}, atol {EPOCH_ATOL}; the flips:")
    require(flips() == 0, f"{name}: a winner flip lies outside the searches' error floors")


def _pop_epoch_ms(torch, step, w, chunks, mask):
    """Epochs 3-5 of a 10-epoch schedule of ``step`` (after one unmeasured)
    on device-resident chunks, each between CUDA events; milliseconds."""
    w = step(w, chunks, mask, 2)
    times = []
    for t in range(3, 6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        w = step(w, chunks, mask, t)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _pop_stream_ms(torch, pop, src, strategy):
    """Streamed epochs 3-5 of a 10-epoch schedule (``train(src)`` one epoch
    a call, after one unmeasured), each between CUDA events; the call's
    codebook upload and write-back included; milliseconds."""
    pop.train(src, 10, iter_beg=2, iter_end=3, strategy=strategy)
    times = []
    for t in range(3, 6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pop.train(src, 10, iter_beg=t, iter_end=t + 1, strategy=strategy)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _population_sweep(torch, card, cfg, workdir):
    """One sweep of the population phase (``phase_population``). Returns
    the streamed fused and batched epoch medians (ms)."""
    from xpysom_dask_tpu_torch import SomPopulation, XPySom
    from xpysom_dask_tpu_torch.models import population as pm
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import ArraySource

    name, p, dims = cfg["name"], cfg["p"], (cfg["x"], cfg["y"], cfg["d"])
    xy = cfg["x"] * cfg["y"]
    data = _flagship_rows(cfg["n"], cfg["d"])

    def make():
        pop = SomPopulation(p, *dims, **cfg["kw"])
        pop._superbatch_rows = lambda: cfg["rows"]
        return pop

    pop0 = make()
    w0 = pop0.weights
    chunk_m = _pop_chunk(pop0, "serial", cfg["n"])
    chunk_b = _pop_chunk(pop0, "batched", cfg["n"])
    require(cfg["rows"] % chunk_m == 0 and cfg["rows"] % chunk_b == 0,
            f"{name}: superbatch {cfg['rows']} not a multiple of the chunks {chunk_m}, {chunk_b}")
    n_m, n_b = -(-cfg["n"] // chunk_m), -(-cfg["n"] // chunk_b)
    print(f"population {name}: P = {p} maps of {dims[0]} x {dims[1]} x {dims[2]} "
          f"({p * xy} stacked nodes) on {cfg['n']} rows; serial/fused chunk {chunk_m} "
          f"({n_m} a pass), batched chunk {chunk_b} ({n_b} a pass)")

    def run(strategy, src=None, epochs=(0, 2)):
        pop = make()
        kernels.reset_launch_counts()
        pop.train(data if src is None else src, 2, iter_beg=epochs[0], iter_end=epochs[1],
                  strategy=strategy)
        counts = kernels.launch_counts()
        w = pop.weights
        require(w.shape == (p, *dims) and np.isfinite(w).all(), f"{name}: {strategy} malformed")
        return pop, w, counts

    def expect(strategy, counts, epochs):
        k1 = 0 if strategy == "batched" else n_m * p * epochs
        k9 = (n_b if strategy == "batched" else n_m) * p * epochs
        got = (counts["bmu_argmin"], counts["scatter_stats"])
        require(got == (k1, k9), f"{name} {strategy}: K1/K9 launches {got}, expected {(k1, k9)}")
        others = {k: v for k, v in counts.items()
                  if v and k not in ("bmu_argmin", "scatter_stats") and "." not in k}
        require(not others, f"{name} {strategy}: other kernels launched {others}")
        return got

    # serial, one epoch then the second, each member against lone runs
    pop_s = make()
    kernels.reset_launch_counts()
    pop_s.train(data, 2, iter_end=1, strategy="serial")
    w1 = pop_s.weights
    pop_s.train(data, 2, iter_beg=1, strategy="serial")
    ws = pop_s.weights
    c_serial = expect("serial", kernels.launch_counts(), 2)
    for i in range(p):
        lone = XPySom(*dims, **_member_kw(cfg, i)).train(data, 2)
        require(np.array_equal(ws[i].view(np.int32), lone.get_weights().view(np.int32)),
                f"{name}: serial member {i} differs from its lone training in bits")
    print(f"population {name}: serial, 2 epochs: every member bitwise equal to its lone "
          f"XPySom training; launches K1, K9 {c_serial}")
    for e, (start, end) in enumerate(((w0, w1), (w1, ws))):
        for i in range(p):
            kw = _member_kw(cfg, i)
            plain_kw = dict(kw, use_kernels=False, n_parallel=chunk_m)
            plain = XPySom.from_numpy(start[i], **plain_kw)
            plain.train(data, 2, iter_beg=e, iter_end=e + 1)

            def flips(i=i, kw=kw, plain_kw=plain_kw, start=start):
                a = XPySom.from_numpy(start[i], **kw).predict(data)
                b = XPySom.from_numpy(start[i], **plain_kw).predict(data)
                return _search_flips(f"{name} member {i} epoch {e}: K1 vs plain", data,
                                     start[i].reshape(xy, -1), a, b)

            _held_epoch(f"{name} member {i} epoch {e}: serial vs the plain versions from the "
                        "same codebook", end[i], plain.get_weights(), flips)

    # fused: the same chunks in the same order, so serial's bits
    pop_f, wf, counts = run("fused")
    c_fused = expect("fused", counts, 2)
    require(np.array_equal(wf.view(np.int32), ws.view(np.int32)),
            f"{name}: fused differs from serial in bits")
    print(f"population {name}: fused, 2 epochs: bitwise equal to serial; launches K1, K9 "
          f"{c_fused}")

    # batched: one epoch against serial's, then QE after two
    _, wb1, counts = run("batched", epochs=(0, 1))
    c_b1 = expect("batched", counts, 1)

    def batched_flips():
        got = _pop_winners(pop0, w0, data)
        bad = 0
        for i in range(p):
            k1 = XPySom.from_numpy(w0[i], **_member_kw(cfg, i)).predict(data)
            bad += _search_flips(f"{name} member {i}: batched fp32 vs K1 packed", data,
                                 w0[i].reshape(xy, -1), got[i], k1)
        return bad

    _held_epoch(f"{name}: batched vs serial after 1 epoch", wb1, w1, batched_flips)
    pop_b, wb, counts = run("batched")
    c_batched = expect("batched", counts, 2)
    qe_s, qe_b = pop_s.quantization_errors(data), pop_b.quantization_errors(data)
    qe0 = pop0.quantization_errors(data)
    require(np.isfinite(qe_b).all() and (qe_s < qe0).all(), f"{name}: QE did not fall")
    require(np.allclose(qe_b, qe_s, rtol=0.05), f"{name}: batched QE {qe_b} vs serial {qe_s}")
    print(f"population {name}: batched, 1 epoch launches K1, K9 {c_b1}; 2 epochs {c_batched}; "
          f"QE after 2 epochs batched {qe_b.tolist()} vs serial {qe_s.tolist()} (rtol 0.05; "
          f"initial {qe0.tolist()})")

    # streamed through ArraySource, superbatches of whole chunks
    src = ArraySource(data)
    streamed = {}
    for strategy, resident in (("fused", wf), ("batched", wb)):
        pop, w, counts = run(strategy, src)
        got = expect(strategy, counts, 2)
        require(np.array_equal(w.view(np.int32), resident.view(np.int32)),
                f"{name}: streamed {strategy} differs from resident in bits")
        streamed[strategy] = w
        print(f"population {name}: streamed {strategy} (superbatches of {cfg['rows']}), "
              f"2 epochs: bitwise equal to resident; launches K1, K9 {got}")
    qe_src = pop_s.quantization_errors(src)
    tol = (n_b - 1) * F32_U
    require(np.all(np.abs(qe_src - qe_s) <= tol * np.abs(qe_s)),
            f"{name}: streamed QE {qe_src} vs resident {qe_s} beyond {tol:.3g} relative")
    print(f"population {name}: streamed quantization_errors within {tol:.3g} relative of "
          f"resident (largest {float(np.max(np.abs(qe_src - qe_s) / qe_s)):.3g})")
    path = os.path.join(workdir, "population.npz")
    make().train(src, 2, iter_end=1, checkpoint_path=path, checkpoint_every=1)
    resumed = SomPopulation.load_checkpoint(path)
    require(resumed._checkpoint_epoch == 1, f"{name}: checkpoint epoch {resumed._checkpoint_epoch}")
    resumed._superbatch_rows = lambda: cfg["rows"]
    resumed.train(src, 2, iter_beg=resumed._checkpoint_epoch)
    require(np.array_equal(resumed.weights.view(np.int32), streamed["fused"].view(np.int32)),
            f"{name}: the resumed streamed sweep differs from the uninterrupted one in bits")
    print(f"population {name}: streamed auto (fused) 1 epoch, checkpoint, load_checkpoint, "
          "1 epoch: bitwise equal to 2 uninterrupted epochs")

    # epoch times, every member, device-resident chunks and streamed;
    # 'serial' runs fused's epoch, so it is timed once
    specs = pop0._specs()
    update = pm._pop_update(specs, 10)
    times = {}
    for strategy, make_stats in (("fused", pm._make_pop_stats_fused),
                                 ("batched", pm._make_pop_stats)):
        chunks, mask, _ = pop0.member(0)._chunked(data, pop0._chunk_budget(strategy))
        stats = make_stats(specs)

        def step(w, chunks, mask, t, stats=stats):
            return update(w, stats(w, chunks, mask), t)

        times[strategy] = _pop_epoch_ms(torch, step, pop0._stacked_device_weights(), chunks, mask)
        del chunks, mask
    for strategy in ("fused", "batched"):
        times["streamed " + strategy] = _pop_stream_ms(torch, make(), src, strategy)
    med = {k: sorted(v)[1] for k, v in times.items()}
    print(f"population {name} epoch times, all {p} members (CUDA events, ms, median of 3 after "
          "a warm-up): " + "; ".join(
              f"{k} {[round(t, 3) for t in v]} median {med[k]:.3f}" for k, v in times.items())
          + f" ({card})")
    return med["streamed fused"], med["streamed batched"]


def _pop_chunk(pop, strategy, n):
    """The resident chunk a population trains ``n`` rows with."""
    from xpysom_dask_tpu_torch.utils.hw import training_chunk

    return training_chunk(n, pop._chunk_budget(strategy))


def phase_population(torch, card, workdir):
    """``SomPopulation`` on the card at the two sweeps of ``POP_SWEEPS``:
    K1 and K9 at the sweep's 576 nodes against their plain versions; per
    sweep, serial (2 epochs) bitwise equal to lone ``XPySom`` training and
    each epoch within the epochs tolerance of the plain versions from the
    same codebook; fused bitwise equal to serial; batched within the
    tolerance of serial after 1 epoch (or every flip a float64 near-tie
    within the two searches' floors) and by QE after 2; streamed fused and
    batched bitwise equal to resident, streamed QE within the f32
    summation bound, a streamed checkpoint resume bitwise; exact K1/K9
    launches per strategy; epoch times. Then whether the measured streamed
    times bear out streamed ``'auto'`` running ``'fused'`` at every size."""
    from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
    from xpysom_dask_tpu_torch.ops.kernels import stats as ks

    sweep = POP_SWEEPS[0]
    xy = sweep["x"] * sweep["y"]
    rng = np.random.RandomState(12)
    x = rng.rand(16384, sweep["d"]).astype(np.float32)
    w = rng.rand(xy, sweep["d"]).astype(np.float32) * 2 - 1
    _, _, _, idx, _ = compare_bmu(torch, kb, f"K1/K2 at the sweep's {xy} nodes", x, w)
    compare_stats(torch, ks, f"K9 at the sweep's {xy} nodes, K1's winners", x,
                  (rng.rand(16384) > 0.05).astype(np.float32), idx, xy)

    gate = []
    for cfg in POP_SWEEPS:
        fused, batched = _population_sweep(torch, card, cfg, workdir)
        nodes = cfg["p"] * cfg["x"] * cfg["y"]
        gate.append(f"{nodes} stacked nodes: streamed fused {fused:.3f} ms, batched "
                    f"{batched:.3f} ms")
        require(batched * 1.2 > fused, f"streamed batched ({batched:.3f} ms) beat fused "
                f"({fused:.3f} ms) at {nodes} stacked nodes, where streamed 'auto' runs fused")
    print("population streaming: 'auto' runs fused; " + "; ".join(gate) + f" ({card})")


# The distributed phase: the flagship at full width, its 2^19 rows also in
# three shard files that ShardedFileSource splits unevenly over two ranks
# (files[0::2]: 374,288 rows, files[1::2]: 150,000), and 4 flagship maps
# as the population phase's flagship sweep. Each worker is killed at the
# timeout, and the phase fails then.
DIST_SHARDS = (200000, 150000, 174288)
DIST_POP = dict(sigma=[64, 48, 32, 16], sigmaN=1, learning_rate=0.5, learning_rateN=0.01,
                random_seed=0)
DIST_TIMEOUT_S = 240


def _shard_paths(root):
    return [os.path.join(root, f"shard{i}.f32") for i in range(len(DIST_SHARDS))]


def _timed(torch, walls, name, fn):
    """``fn()``, its wall time (host clock, synchronized) in ``walls``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def _expect_counts(name, counts, want):
    """The launches of a path: exactly ``want`` (name: count), no other
    kernel. K1's and K2's launches by feed (``<name>.paired``,
    ``<name>.registers``) are held only to their kernel's launches here;
    ``phase_feeds`` checks them exactly."""
    got = {k: v for k, v in counts.items() if v and "." not in k}
    require(got == want, f"{name}: launches {got}, expected {want}")
    for k, v in counts.items():
        if "." in k:
            require(v <= counts.get(k.split(".")[0], 0), f"{name}: {k} {v} over its launches")


def dist_worker(rank, world, backend, store):
    """One rank of the distributed phase (``--dist-worker RANK WORLD
    BACKEND DIR``): ``backend`` over the ``file://`` store in DIR, on the
    rank's card (``cuda:{rank % cards}``); each step on the flagship, its
    results in ``DIR/rank{RANK}.npz`` and a JSON line of its times and
    launches."""
    import torch
    import torch.distributed as dist

    from xpysom_dask_tpu_torch import SomPopulation, XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import ShardedFileSource, initialize_multihost

    f = FLAGSHIP
    dims = (f["x"], f["y"], f["d"])
    # no CUDA call before the join, which makes the rank's card current
    t0 = time.perf_counter()
    initialize_multihost(f"file://{store}/rendezvous", world, rank, backend=backend)
    walls, out = {"join": time.perf_counter() - t0}, {}
    require(dist.get_backend() == backend, f"backend {dist.get_backend()}")
    data = _flagship_rows(f["n"], f["d"])
    som = XPySom(*dims, **FLAGSHIP_KW, mesh="auto")
    require(som._mesh.world == world and som._device.type == "cuda", f"mesh {som._mesh}")

    kernels.reset_launch_counts()
    chunks, mask, _ = som._chunked(data)
    w0 = som._device_weights()
    out["acc"] = _timed(torch, walls, "statistics", lambda: core.make_stats_fn(
        som._spec, som._mesh)(w0, chunks, mask)).cpu().numpy()
    out["w2"] = _timed(torch, walls, "train 2 epochs", lambda: som.train(data, 2)).get_weights()
    out["predict"] = _timed(torch, walls, "predict", lambda: som.predict(data))
    out["qe"], out["te"] = _timed(torch, walls, "QE and TE", lambda: (
        som.quantization_error(data), som.topographic_error(data)))
    counts = kernels.launch_counts()
    per = chunks.shape[0]
    _expect_counts(f"rank {rank}", counts,
                   {"bmu_argmin": 5 * per, "scatter_stats": 3 * per, "bmu_top2": per})
    epoch_ms = _pop_epoch_ms(torch, core.make_epoch_step(som._spec, 10, som._mesh), w0,
                             chunks, mask)
    buf = torch.zeros((f["x"] * f["y"], f["d"] + 1), device=som._device)
    all_reduce_ms = cuda_ms(torch, lambda: dist.all_reduce(buf), reps=10, warmup=2)
    del chunks, mask

    path = os.path.join(store, "flagship.npz")
    cut = _timed(torch, walls, "1 epoch and a checkpoint", lambda: XPySom(
        *dims, **FLAGSHIP_KW, mesh="auto").train(data, 2, iter_end=1, checkpoint_path=path,
                                                 checkpoint_every=1))
    out["w1"] = cut.get_weights()
    back = XPySom.load_checkpoint(path, mesh="auto")
    require(back._checkpoint_epoch == 1, f"checkpoint epoch {back._checkpoint_epoch}")
    require(np.array_equal(back.get_weights().view(np.int32), out["w1"].view(np.int32)),
            f"rank {rank}: the checkpoint's codebook is not this rank's")
    out["resumed"] = _timed(torch, walls, "load_checkpoint and 1 epoch",
                            lambda: back.train(data, 2, iter_beg=1)).get_weights()
    require(np.array_equal(out["resumed"].view(np.int32), out["w2"].view(np.int32)),
            f"rank {rank}: the resumed codebook differs from the uninterrupted one in bits")

    src = ShardedFileSource(_shard_paths(store), f["d"], mesh=som._mesh)
    out["stream_rows"] = len(src)
    out["stream_w"] = _timed(torch, walls, "streamed epoch", lambda: XPySom(
        *dims, **FLAGSHIP_KW, mesh="auto").train(src, 2, iter_end=1)).get_weights()
    out["pop_w"] = _timed(torch, walls, "population epoch, 4 flagship maps", lambda: SomPopulation(
        4, *dims, **DIST_POP, mesh="auto").train(data, 2, iter_end=1, strategy="fused")).weights
    require("jax" not in sys.modules, "JAX was imported")
    np.savez(os.path.join(store, f"rank{rank}.npz"), **out)
    print("dist worker " + json.dumps({"rank": rank, "walls_s": walls, "epoch_ms": epoch_ms,
                                       "all_reduce_ms": all_reduce_ms,
                                       "launches": {k: v for k, v in counts.items() if v}}))
    dist.destroy_process_group()
    return 0


def phase_distributed(torch, card, workdir):
    """Data parallel over ``torch.distributed`` at the flagship's full
    width (phase 18 of the module docstring): (a) here, (b) in
    :func:`phase_ranks`. Every rank's codebooks are compared bit for bit
    with the others' and, with the epochs tolerance (or every winner flip a
    float64 near-tie inside the searches' floors), with one process's."""
    import torch.distributed as dist

    from xpysom_dask_tpu_torch import XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import initialize_multihost

    t_phase = time.perf_counter()
    f = FLAGSHIP
    dims = (f["x"], f["y"], f["d"])
    n_chunks = f["n"] // f["chunk"]
    data = _flagship_rows(f["n"], f["d"])

    def bits(a):
        return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)

    # (a) a world of one on NCCL: no collective runs, so mesh='auto' is
    # the single-device path bit for bit
    initialize_multihost(f"file://{workdir}/world1.store", 1, 0)
    try:
        require(dist.get_backend() == "nccl", f"world 1: backend {dist.get_backend()}")
        kernels.reset_launch_counts()
        meshed = XPySom(*dims, **FLAGSHIP_KW, mesh="auto").train(data, 2)
        got = (meshed.quantization_error(data), meshed.topographic_error(data),
               meshed.predict(data))
        _expect_counts("world 1", kernels.launch_counts(), {
            "bmu_argmin": 4 * n_chunks, "scatter_stats": 2 * n_chunks, "bmu_top2": n_chunks})
        single = XPySom(*dims, **FLAGSHIP_KW).train(data, 2)
        want = (single.quantization_error(data), single.topographic_error(data),
                single.predict(data))
        require(meshed._mesh.world == 1 and meshed._device.type == "cuda", f"{meshed!r}")
        require(np.array_equal(bits(meshed.get_weights()), bits(single.get_weights())),
                "world 1: the codebook differs from mesh=None in bits")
        require(got[0] == want[0] and got[1] == want[1] and np.array_equal(got[2], want[2]),
                f"world 1: QE/TE {got[:2]} vs {want[:2]}, or predict, differ from mesh=None")
        print(f"distributed, world 1 on NCCL: 2 epochs, QE {got[0]!r}, TE {got[1]!r} and "
              f"predict bitwise equal to mesh=None; launches K1 {4 * n_chunks}, K9 "
              f"{2 * n_chunks}, K2 {n_chunks}")

        spec = single._spec
        chunks, mask, _ = single._chunked(data)
        w0 = XPySom(*dims, **FLAGSHIP_KW)._device_weights()
        stats, update = core.make_stats_fn(spec), core.make_update_fn(spec, 10)

        def reduced(w, chunks, mask, t):
            acc = stats(w, chunks, mask)
            dist.all_reduce(acc)
            return update(w, acc, t)

        steps = {"mesh=None": core.make_epoch_step(spec, 10),
                 "mesh='auto'": core.make_epoch_step(spec, 10, meshed._mesh),
                 "+ NCCL all_reduce": reduced}
        require(np.array_equal(bits(reduced(w0, chunks, mask, 0).cpu()),
                               bits(steps["mesh=None"](w0, chunks, mask, 0).cpu())),
                "world 1: an NCCL all_reduce changed the epoch's bits")
        times = {k: [] for k in steps}
        for order in (list(steps), list(steps)[::-1]):  # in turns
            for k in order:
                times[k].append(_pop_epoch_ms(torch, steps[k], w0, chunks, mask))
        acc = stats(w0, chunks, mask)
        ar_ms = [cuda_ms(torch, lambda: dist.all_reduce(acc), reps=20, warmup=3) for _ in range(3)]
        print("distributed, world 1 epoch times (CUDA events, ms, median of 3 after a warm-up, "
              "two turns): " + "; ".join(
                  f"{k} {sorted(a)[1]:.3f} [{', '.join(f'{t:.3f}' for t in a)}], "
                  f"{sorted(b)[1]:.3f} [{', '.join(f'{t:.3f}' for t in b)}]"
                  for k, (a, b) in times.items())
              + f"; NCCL all_reduce of [S | cnt] ({acc.numel() * 4} bytes) alone "
              f"{', '.join(f'{t:.4f}' for t in ar_ms)} ms (mean of 20, three times) ({card})")
        del chunks, mask, acc
    finally:
        dist.destroy_process_group()

    # (b) two ranks on the one card over gloo (NCCL refuses two ranks on
    # one card)
    phase_ranks(torch, card, workdir, 2, "gloo")
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s ({card})")


def phase_ranks(torch, card, workdir, world, backend):
    """``world`` ranks of ``chip_smoke.py --dist-worker`` over ``backend``
    (phase 18 (b): 2 on gloo on the one card; ``--dist-cards N``: N on
    NCCL, one a card), held against one process's run on the same data and
    each other: statistics, 2 epochs, scoring, a checkpoint resume, a
    streamed epoch from ``files[rank::world]`` of the three shard files and
    a fused population epoch of 4 flagship maps."""
    from xpysom_dask_tpu_torch import SomPopulation, XPySom, core

    f = FLAGSHIP
    dims, xy = (f["x"], f["y"], f["d"]), f["x"] * f["y"]
    data = _flagship_rows(f["n"], f["d"])
    name = f"distributed, {world} ranks on {backend}"
    store = os.path.join(workdir, f"dist{world}")
    os.makedirs(store)
    ends = np.cumsum((0,) + DIST_SHARDS)
    for path, a, b in zip(_shard_paths(store), ends[:-1], ends[1:]):
        data[a:b].tofile(path)
    single = XPySom(*dims, **FLAGSHIP_KW)
    w0 = single.get_weights().astype(np.float32)
    chunks, mask, _ = single._chunked(data)
    ref_acc = core.make_stats_fn(single._spec)(torch.from_numpy(w0).to(chunks.device), chunks,
                                               mask).cpu().numpy()
    del chunks, mask
    w1 = XPySom(*dims, **FLAGSHIP_KW).train(data, 2, iter_end=1).get_weights()
    w2 = single.train(data, 2).get_weights()
    pop1 = SomPopulation(4, *dims, **DIST_POP).train(data, 2, iter_end=1, strategy="fused").weights
    t0 = time.perf_counter()
    logs = _run_ranks(store, world, backend, "--dist-worker", DIST_TIMEOUT_S)
    took = time.perf_counter() - t0
    res = []
    for r, log in enumerate(logs):
        line = [ln for ln in log.splitlines() if ln.startswith("dist worker ")]
        require(line, f"{name}: rank {r} printed no result:\n{log[-4000:]}")
        rec = json.loads(line[-1][len("dist worker "):])
        with np.load(os.path.join(store, f"rank{r}.npz")) as z:
            rec.update({k: z[k] for k in z.files})
        res.append(rec)
        print(f"{name}, rank {r}: walls (s) "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec["walls_s"].items())
              + f"; epoch {', '.join(f'{t:.3f}' for t in rec['epoch_ms'])} ms (CUDA events); "
              f"{backend} all_reduce of [S | cnt] alone {rec['all_reduce_ms']:.4f} ms (mean of "
              f"10); launches {rec['launches']} ({card})")
    r0 = res[0]
    for k in ("acc", "w2", "w1", "resumed", "predict", "qe", "te", "stream_w", "pop_w"):
        a = np.atleast_1d(r0[k])
        for r, rec in enumerate(res[1:], 1):
            b = np.atleast_1d(rec[k])
            require(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)),
                    f"{name}: rank {r}'s {k} differs from rank 0's in bits")
    acc = r0["acc"]
    require(np.array_equal(acc[:, -1], ref_acc[:, -1]), f"{name}: cnt differs from one process's")
    require(np.allclose(acc[:, :-1], ref_acc[:, :-1], rtol=1e-5, atol=1e-5),
            f"{name}: S beyond rtol 1e-5, atol 1e-5 of one process's: max|dS| "
            f"{np.abs(acc[:, :-1] - ref_acc[:, :-1]).max():.3g}")
    require(np.allclose(r0["w1"], w1, rtol=EPOCH_RTOL, atol=EPOCH_ATOL),
            f"{name}: epoch 0 beyond the epochs tolerance of one process's")

    def flips():
        a = XPySom.from_numpy(r0["w1"], **FLAGSHIP_KW).predict(data)
        b = XPySom.from_numpy(w1, **FLAGSHIP_KW).predict(data)
        return _search_flips(f"{name}, epoch 1 vs one process", data, w1.reshape(xy, -1), a, b)

    _held_epoch(f"{name} vs one process, 2 epochs", r0["w2"], w2, flips)
    same = XPySom.from_numpy(r0["w2"], **FLAGSHIP_KW)
    require(np.array_equal(r0["predict"], same.predict(data)),
            f"{name}: the gathered winners differ from one process's on the same codebook")
    qe, te = same.quantization_error(data), same.topographic_error(data)
    require(abs(float(r0["qe"]) - qe) <= 1e-6 * qe and float(r0["te"]) == te,
            f"{name}: QE/TE {float(r0['qe'])!r}, {float(r0['te'])!r} vs one process's "
            f"{qe!r}, {te!r} on the same codebook")
    rows = [int(r["stream_rows"]) for r in res]
    require(rows == [sum(DIST_SHARDS[r::world]) for r in range(world)], f"shard rows {rows}")
    require(np.allclose(r0["stream_w"], w1, rtol=EPOCH_RTOL, atol=EPOCH_ATOL),
            f"{name}: the streamed epoch beyond the epochs tolerance of one process's "
            f"resident epoch: max|dw| {np.abs(r0['stream_w'] - w1).max():.3g}")
    require(np.allclose(r0["pop_w"], pop1, rtol=EPOCH_RTOL, atol=EPOCH_ATOL),
            f"{name}: the population epoch beyond the epochs tolerance of one process's: "
            f"max|dw| {np.abs(r0['pop_w'] - pop1).max():.3g}")
    print(f"{name}: every result bitwise equal across the ranks; cnt equal to one process's, "
          f"max|dS| {np.abs(acc[:, :-1] - ref_acc[:, :-1]).max():.3g}; 2 epochs max|dw| "
          f"{np.abs(r0['w2'] - w2).max():.3g}; checkpoint resume bitwise; predict bitwise, QE "
          f"and TE as one process's on the same codebook; streamed epoch (rows {rows}) "
          f"max|dw| {np.abs(r0['stream_w'] - w1).max():.3g}; population epoch max|dw| "
          f"{np.abs(r0['pop_w'] - pop1).max():.3g}; the workers {took:.1f} s")


# Phase 19, codebook sharding: the flagship on (data, model) grids; on four
# cards also a 512 x 512 x 64 map at (1, 4) on 2^17 rows, the size codebook
# sharding exists for (65,536 nodes, 16.8 MB of codebook a rank). Each rank
# is killed at the timeout, and the phase fails then.
GRID_BIG = dict(x=512, y=512, d=64, n=1 << 17)
GRID_TIMEOUT_S = 300


def _sha(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _grid_parts_ms(torch, gs, spec, mesh, w_local, chunks, mask):
    """A grid's epoch (epochs 3-5 of 10, CUDA events, after one unmeasured,
    the centre carried as training carries it), the per-chunk merge alone
    (the shard's winners of chunk 0 merged over the model group, mean of
    20) and the update's gather alone (the shard's ``[S | cnt]`` and
    codebook over the model group, mean of 10); milliseconds."""
    import torch.distributed as dist

    from xpysom_dask_tpu_torch.parallel import fetch_global

    step = gs.make_epoch_fn_2d(spec, 10, mesh)
    center = [None]

    def epoch(w, c, m, t):
        w, center[0] = step(w, c, m, t, center[0])
        return w

    epoch_ms = _pop_epoch_ms(torch, epoch, w_local, chunks, mask)
    shard = gs._Shard(spec, spec.distance_fn(), mesh, w_local)
    idx, val = shard.search.argmin(chunks[0], True)
    merge_ms = cuda_ms(torch, lambda: gs._global_bmu(val, idx, shard.offset, mesh), reps=20)
    # the merge's parts: the key arithmetic alone, its all_reduce(MIN) alone,
    # an all_reduce(SUM) of as many f32 bytes, and one all_reduce(MIN) of
    # every chunk's keys at once
    key = gs.merge_key(val, idx)
    parts = {
        "keys": cuda_ms(torch, lambda: gs._split_key(gs.merge_key(val, idx)), reps=20),
        "all_reduce MIN int64": cuda_ms(torch, lambda: dist.all_reduce(
            key, op=dist.ReduceOp.MIN, group=mesh.model.group), reps=20),
        "all_reduce SUM f32, same bytes": cuda_ms(torch, lambda: dist.all_reduce(
            key.view(torch.float32), group=mesh.model.group), reps=20),
    }
    every = key.repeat(chunks.shape[0])
    parts[f"all_reduce MIN int64 of {chunks.shape[0]} chunks' keys"] = cuda_ms(
        torch, lambda: dist.all_reduce(every, op=dist.ReduceOp.MIN, group=mesh.model.group),
        reps=5)
    acc = gs.make_stats_fn_2d(spec, mesh)(w_local, chunks, mask)
    gather_ms = cuda_ms(torch, lambda: (gs.gather_codebook(w_local, mesh),
                                        fetch_global(acc, mesh.model)))
    return epoch_ms, merge_ms, gather_ms, parts


def grid_worker(rank, world, backend, store):
    """One rank of the grid phase (``--grid-worker RANK WORLD BACKEND
    DIR``): ``backend`` over the ``file://`` store in DIR, on the rank's
    card. The flagship on a (2, 2) grid (and (1, 4) on four cards): 2
    epochs, ``predict``, QE and TE with the launch counts, the grid epoch
    beside the data mesh of the same world, the merge and the gather alone;
    on ranks 0 and 1 a 2-rank data mesh and a (1, 2) grid; on four cards
    the 512 x 512 x 64 map at (1, 4). Results in ``DIR/grid{RANK}.npz``
    and a JSON line of times and launches."""
    import torch
    import torch.distributed as dist

    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import initialize_multihost, make_data_mesh, make_grid_mesh
    from xpysom_dask_tpu_torch.parallel import grid_sharded as gs
    from xpysom_dask_tpu_torch.parallel.mesh import barrier

    f = FLAGSHIP
    dims, n_chunks = (f["x"], f["y"], f["d"]), f["n"] // f["chunk"]
    initialize_multihost(f"file://{store}/rendezvous", world, rank, backend=backend)
    require(dist.get_backend() == backend, f"backend {dist.get_backend()}")
    pair = dist.new_group([0, 1])  # every rank enters; ranks 0 and 1 use it
    whole = make_data_mesh()
    data = _flagship_rows(f["n"], f["d"])
    out, rec = {}, {"rank": rank, "grids": {}}
    grids = [(2, 2), (1, 4)] if backend == "nccl" and world == 4 else [(2, 2)]
    for shape in grids:
        name = f"{shape[0]}x{shape[1]}"
        mesh = make_grid_mesh(*shape)
        som = XPySom(*dims, **FLAGSHIP_KW, mesh=mesh)
        require(som._device.type == "cuda", f"grid {name} on {som._device}")
        kernels.reset_launch_counts()
        out[f"w2_{name}"] = som.train(data, 2).get_weights()
        out[f"predict_{name}"] = som.predict(data)
        out[f"qe_{name}"] = som.quantization_error(data)
        out[f"te_{name}"] = som.topographic_error(data)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        per = n_chunks // shape[0]
        _expect_counts(f"grid {name}, rank {rank}", counts,
                       {"bmu_argmin": 4 * per, "scatter_stats": 2 * per, "bmu_top2": per})
        fresh = XPySom(*dims, **FLAGSHIP_KW, mesh=mesh)
        chunks, mask, _ = fresh._chunked(data)
        epoch, merge, gather, parts = _grid_parts_ms(torch, gs, fresh._spec, mesh,
                                                     fresh._device_weights(), chunks, mask)
        del chunks, mask
        flat = XPySom(*dims, **FLAGSHIP_KW, mesh=whole)
        chunks, mask, _ = flat._chunked(data)
        from xpysom_dask_tpu_torch import core

        data_ms = _pop_epoch_ms(torch, core.make_epoch_step(flat._spec, 10, whole),
                                flat._device_weights(), chunks, mask)
        del chunks, mask
        rec["grids"][name] = {"launches": counts, "epoch_ms": epoch, "data_mesh_epoch_ms": data_ms,
                              "merge_ms": merge, "merge_parts_ms": parts, "gather_ms": gather}
        if shape == (2, 2):  # epoch 1, which the flips of epoch 2 are searched from
            out["w1_2x2"] = XPySom(*dims, **FLAGSHIP_KW, mesh=mesh).train(
                data, 2, iter_end=1).get_weights()
    if rank < 2:
        out["w2_dm2"] = XPySom(*dims, **FLAGSHIP_KW, mesh=make_data_mesh(group=pair)).train(
            data, 2).get_weights()
        som = XPySom(*dims, **FLAGSHIP_KW, mesh=make_grid_mesh(1, 2, group=pair))
        kernels.reset_launch_counts()
        out["w2_1x2"] = som.train(data, 2).get_weights()
        out["predict_1x2"] = som.predict(data)
        rec["grids"]["1x2"] = {"launches": {k: v for k, v in kernels.launch_counts().items()
                                            if v}}
    if backend == "nccl" and world == 4:
        b = GRID_BIG
        xb = _flagship_rows(b["n"], b["d"])
        mesh = make_grid_mesh(1, 4)
        som = XPySom(b["x"], b["y"], b["d"], **FLAGSHIP_KW, mesh=mesh)
        kernels.reset_launch_counts()
        w1 = som.train(xb, 1).get_weights()
        out["big_te"] = som.topographic_error(xb)
        out["big_sha"] = _sha(w1)
        if rank == 0:
            out["big_w1"] = w1
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        fresh = XPySom(b["x"], b["y"], b["d"], **FLAGSHIP_KW, mesh=mesh)
        chunks, mask, _ = fresh._chunked(xb)
        epoch, merge, gather, parts = _grid_parts_ms(torch, gs, fresh._spec, mesh,
                                                     fresh._device_weights(), chunks, mask)
        rec["grids"]["big 1x4"] = {"launches": counts, "epoch_ms": epoch, "merge_ms": merge,
                                   "merge_parts_ms": parts, "gather_ms": gather}
    barrier(whole)
    require("jax" not in sys.modules, "JAX was imported")
    np.savez(os.path.join(store, f"grid{rank}.npz"), **out)
    print("grid worker " + json.dumps(rec))
    dist.destroy_process_group()
    return 0


def _run_ranks(store, world, backend, flag, timeout_s):
    """``world`` ranks of this script run as ``flag RANK WORLD BACKEND
    DIR``, started together; all are killed at the timeout or when one
    fails. Returns each rank's output."""
    cmd = [sys.executable, os.path.abspath(__file__), flag]
    procs = [subprocess.Popen(cmd + [str(r), str(world), backend, store],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{flag}: a rank did not finish in {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"{flag}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return logs


def phase_grid(torch, card, workdir):
    """Codebook sharding (phase 19 of the module docstring): (a) a (1, 1)
    grid on NCCL, a world of one, bit for bit ``mesh=None``, with its
    launch counts and epoch times beside ``mesh=None`` and the data mesh of
    the same world; (b) :func:`phase_grid_ranks`, four gloo ranks on the
    one card. Returns (a)'s launch counts."""
    import torch.distributed as dist

    from xpysom_dask_tpu_torch import XPySom, core
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.parallel import initialize_multihost, make_data_mesh, make_grid_mesh
    from xpysom_dask_tpu_torch.parallel import grid_sharded as gs

    t_phase = time.perf_counter()
    f = FLAGSHIP
    dims, n_chunks = (f["x"], f["y"], f["d"]), f["n"] // f["chunk"]
    data = _flagship_rows(f["n"], f["d"])

    def bits(a):
        return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)

    initialize_multihost(f"file://{workdir}/grid1.store", 1, 0)
    try:
        require(dist.get_backend() == "nccl", f"grid (1, 1): backend {dist.get_backend()}")
        grid = make_grid_mesh(1, 1)
        kernels.reset_launch_counts()
        meshed = XPySom(*dims, **FLAGSHIP_KW, mesh=grid).train(data, 2)
        got = (meshed.quantization_error(data), meshed.topographic_error(data),
               meshed.predict(data))
        counts = kernels.launch_counts()
        _expect_counts("grid (1, 1)", counts, {
            "bmu_argmin": 4 * n_chunks, "scatter_stats": 2 * n_chunks, "bmu_top2": n_chunks})
        single = XPySom(*dims, **FLAGSHIP_KW).train(data, 2)
        want = (single.quantization_error(data), single.topographic_error(data),
                single.predict(data))
        require(np.array_equal(bits(meshed.get_weights()), bits(single.get_weights())),
                "grid (1, 1): the codebook differs from mesh=None in bits")
        require(got[0] == want[0] and got[1] == want[1] and np.array_equal(got[2], want[2]),
                f"grid (1, 1): QE/TE {got[:2]} vs {want[:2]}, or predict, differ from mesh=None")
        print(f"grid (1, 1) on NCCL: 2 epochs, QE {got[0]!r}, TE {got[1]!r} and predict bitwise "
              f"equal to mesh=None; launches K1 {counts['bmu_argmin']}, K9 "
              f"{counts['scatter_stats']}, K2 {counts['bmu_top2']}")

        spec = single._spec
        chunks, mask, _ = single._chunked(data)
        w0 = XPySom(*dims, **FLAGSHIP_KW)._device_weights()
        step = gs.make_epoch_fn_2d(spec, 10, grid)
        center = [None]

        def grid_epoch(w, c, m, t):
            w, center[0] = step(w, c, m, t, center[0])
            return w

        steps = {"mesh=None": core.make_epoch_step(spec, 10),
                 "data mesh, world 1": core.make_epoch_step(spec, 10, make_data_mesh()),
                 "grid (1, 1)": grid_epoch}
        times = {k: [] for k in steps}
        for order in (list(steps), list(steps)[::-1]):  # in turns
            for k in order:
                times[k].append(_pop_epoch_ms(torch, steps[k], w0, chunks, mask))
        print("grid (1, 1) epoch times (CUDA events, ms, median of 3 after a warm-up, two "
              "turns): " + "; ".join(
                  f"{k} {sorted(a)[1]:.3f} [{', '.join(f'{t:.3f}' for t in a)}], "
                  f"{sorted(b)[1]:.3f} [{', '.join(f'{t:.3f}' for t in b)}]"
                  for k, (a, b) in times.items())
              + f" (at one model shard no merge runs; {card})")
        del chunks, mask
    finally:
        dist.destroy_process_group()
    phase_grid_ranks(torch, card, workdir, 4, "gloo")
    print(f"grid phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    return counts


def phase_grid_ranks(torch, card, workdir, world, backend):
    """``world`` ranks of ``chip_smoke.py --grid-worker`` over ``backend``
    (phase 19 (b): 4 on gloo on the one card; ``--dist-cards 4``: 4 on
    NCCL, one a card), held against one process's run on the same data and
    each other. Bitwise: every rank's results against the others', the
    (2, 2) grid against a 2-rank data mesh, a (1, k) grid against one
    process (training and ``predict``), a grid's winners against one
    process's on the same codebook; QE within 1e-6, TE exact, and the
    (2, 2) grid's epochs within the epochs rule of one process's."""
    from xpysom_dask_tpu_torch import XPySom

    f = FLAGSHIP
    dims, xy = (f["x"], f["y"], f["d"]), f["x"] * f["y"]
    data = _flagship_rows(f["n"], f["d"])
    name = f"grid, {world} ranks on {backend}"
    store = os.path.join(workdir, f"grid{world}{backend}")
    os.makedirs(store)
    single = XPySom(*dims, **FLAGSHIP_KW).train(data, 2)
    w2, p2 = single.get_weights(), single.predict(data)
    w1 = XPySom(*dims, **FLAGSHIP_KW).train(data, 2, iter_end=1).get_weights()
    big = backend == "nccl" and world == 4
    if big:
        b = GRID_BIG
        xb = _flagship_rows(b["n"], b["d"])
        one = XPySom(b["x"], b["y"], b["d"], **FLAGSHIP_KW).train(xb, 1)
        big_w1, big_te = one.get_weights(), one.topographic_error(xb)
        del one
    t0 = time.perf_counter()
    logs = _run_ranks(store, world, backend, "--grid-worker", GRID_TIMEOUT_S)
    took = time.perf_counter() - t0
    res = []
    for r, log in enumerate(logs):
        line = [ln for ln in log.splitlines() if ln.startswith("grid worker ")]
        require(line, f"{name}: rank {r} printed no result:\n{log[-4000:]}")
        rec = json.loads(line[-1][len("grid worker "):])
        with np.load(os.path.join(store, f"grid{r}.npz")) as z:
            rec.update({k: z[k] for k in z.files})
        res.append(rec)
        for g, t in rec["grids"].items():
            parts = [f"launches {t['launches']}"]
            if "epoch_ms" in t:
                parts.append("epoch " + ", ".join(f"{v:.3f}" for v in t["epoch_ms"]) + " ms")
            if "data_mesh_epoch_ms" in t:
                parts.append("data mesh of the same world " + ", ".join(
                    f"{v:.3f}" for v in t["data_mesh_epoch_ms"]) + " ms")
            if "merge_ms" in t:
                parts.append(f"merge alone {t['merge_ms']:.4f} ms a chunk (mean of 20; its parts "
                             + ", ".join(f"{k} {v:.4f}" for k, v in t["merge_parts_ms"].items())
                             + f" ms), update's gather alone {t['gather_ms']:.4f} ms (mean of 10)")
            print(f"{name}, rank {r}, grid {g}: " + "; ".join(parts) + f" (CUDA events; {card})")
    r0 = res[0]
    keys = [k for k in r0 if k.startswith(("w2_", "predict_", "qe_", "te_", "big_"))
            and k not in ("w2_dm2", "w2_1x2", "predict_1x2", "big_w1")]
    for k in keys:
        a = np.atleast_1d(r0[k])
        for r, rec in enumerate(res[1:], 1):
            b = np.atleast_1d(rec[k])
            require(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)),
                    f"{name}: rank {r}'s {k} differs from rank 0's in bits")
    for k in ("w2_dm2", "w2_1x2", "predict_1x2"):
        require(np.array_equal(res[1][k].view(np.uint8), r0[k].view(np.uint8)),
                f"{name}: rank 1's {k} differs from rank 0's in bits")
    require(np.array_equal(r0["w2_2x2"].view(np.int32), r0["w2_dm2"].view(np.int32)),
            f"{name}: the (2, 2) grid's codebook differs from the 2-rank data mesh's in bits: "
            f"max|dw| {np.abs(r0['w2_2x2'] - r0['w2_dm2']).max():.3g}")
    for g in [g for g in ("1x2", "1x4") if f"w2_{g}" in r0]:
        require(np.array_equal(r0[f"w2_{g}"].view(np.int32), w2.view(np.int32)),
                f"{name}: the ({g[0]}, {g[2]}) grid's codebook differs from one process's in "
                f"bits: max|dw| {np.abs(r0[f'w2_{g}'] - w2).max():.3g}")
        require(np.array_equal(r0[f"predict_{g}"], p2),
                f"{name}: the ({g[0]}, {g[2]}) grid's winners differ from one process's")

    require(np.allclose(r0["w1_2x2"], w1, rtol=EPOCH_RTOL, atol=EPOCH_ATOL),
            f"{name}: the (2, 2) grid's epoch 0 beyond the epochs tolerance of one process's")

    def flips():
        a = XPySom.from_numpy(r0["w1_2x2"], **FLAGSHIP_KW).predict(data)
        b = XPySom.from_numpy(w1, **FLAGSHIP_KW).predict(data)
        return _search_flips(f"{name}, (2, 2) epoch 1 vs one process", data, w1.reshape(xy, -1),
                             a, b)

    _held_epoch(f"{name}, (2, 2) vs one process, 2 epochs", r0["w2_2x2"], w2, flips)
    same = XPySom.from_numpy(r0["w2_2x2"], **FLAGSHIP_KW)
    require(np.array_equal(r0["predict_2x2"], same.predict(data)),
            f"{name}: the (2, 2) grid's winners differ from one process's on the same codebook")
    qe, te = same.quantization_error(data), same.topographic_error(data)
    require(abs(float(r0["qe_2x2"]) - qe) <= 1e-6 * qe and float(r0["te_2x2"]) == te,
            f"{name}: QE/TE {float(r0['qe_2x2'])!r}, {float(r0['te_2x2'])!r} vs one "
            f"process's {qe!r}, {te!r} on the same codebook")
    msg = ""
    if big:
        require(str(r0["big_sha"]) == _sha(r0["big_w1"]), f"{name}: rank 0's big codebook hash")
        require(np.array_equal(r0["big_w1"].view(np.int32), big_w1.view(np.int32)),
                f"{name}: the 512 x 512 x 64 epoch at (1, 4) differs from one card's in bits: "
                f"max|dw| {np.abs(r0['big_w1'] - big_w1).max():.3g}")
        require(float(r0["big_te"]) == big_te,
                f"{name}: the 512 x 512 x 64 TE {float(r0['big_te'])!r} vs one card's {big_te!r}")
        msg = f"; 512 x 512 x 64 at (1, 4): epoch and TE ({big_te!r}) bitwise one card's"
    print(f"{name}: every result bitwise equal across the ranks; (2, 2) bitwise the 2-rank data "
          f"mesh, max|dw| {np.abs(r0['w2_2x2'] - w2).max():.3g} against one process; "
          f"(1, k) grids bitwise one process (codebook and predict); winners, QE and TE as one "
          f"process's on the same codebook{msg}; the workers {took:.1f} s")


# epoch_anatomy's depths on the card (the JAX package's defaults): each
# stage runs (lo + hi) times as a warm-up, then reps windows at each depth
ANATOMY = dict(lo=2, hi=8, reps=3)
# PERF.md's predictions (ms), written before the first run of the phase; the
# euclidean BMU stage's around the 7.38 ms that K1 with A in registers read
ANATOMY_PREDICTED = {
    "euclidean": {"bmu_ms": (6.9, 7.9), "stats_ms": (11.0, 13.0), "epoch_ms": (11.0, 13.5)},
    "manhattan": {"bmu_ms": (44.0, 47.0), "epoch_ms": (48.0, 51.0)},
}


def phase_anatomy(torch, card):
    """``utils.profiling.epoch_anatomy`` on the flagship (phase 20 of the
    module docstring), under euclidean (K1) and manhattan (K5): every value
    finite, the three stages above 0 ms, the weights bit for bit as they
    were, and each stage's exact launches. Returns the launches of both
    runs, summed."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels
    from xpysom_dask_tpu_torch.utils.profiling import epoch_anatomy

    f = FLAGSHIP
    data = _flagship_rows(f["n"], f["d"])
    per_stage = (ANATOMY["reps"] + 1) * (ANATOMY["lo"] + ANATOMY["hi"]) * (f["n"] // f["chunk"])
    total = {}
    for activation, search in (("euclidean", "bmu_argmin"), ("manhattan", "bmu_manhattan")):
        som = XPySom(f["x"], f["y"], f["d"], **FLAGSHIP_KW, n_parallel=f["chunk"],
                     activation_distance=activation)
        w0 = som.get_weights().copy()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = epoch_anatomy(som, data, **ANATOMY)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        require(np.array_equal(som.get_weights().view(np.int64), w0.view(np.int64)),
                f"anatomy ({activation}): the model's weights changed")
        ms = {k: v for k, v in out.items() if k.endswith("_ms")}
        require(all(np.isfinite(v) for v in ms.values()), f"anatomy ({activation}): {ms}")
        require(all(ms[k] > 0 for k in ("bmu_ms", "stats_ms", "epoch_ms")),
                f"anatomy ({activation}): a stage at or below 0 ms: {ms}")
        both = {search: per_stage, "scatter_stats": per_stage}
        for stage, want in (("bmu", {search: per_stage}), ("stats", both), ("epoch", both)):
            got = out[f"{stage}_launches"]
            _expect_counts(f"anatomy ({activation}) {stage}", got, want)
            # K1 at K = 208: every launch holds A in registers
            regs = per_stage if search == "bmu_argmin" else 0
            require(got.get("bmu_argmin.registers", 0) == regs,
                    f"anatomy ({activation}) {stage}: {got}, {regs} K1 launches with A in "
                    "registers expected")
        _expect_counts(f"anatomy ({activation})", counts, {search: 3 * per_stage,
                                                           "scatter_stats": 2 * per_stage})
        pred = ANATOMY_PREDICTED[activation]
        print(f"anatomy ({activation}, {f['n']} x {f['d']} rows on {f['x']} x {f['y']}, chunk "
              f"{f['chunk']}, CUDA events, {out['bmu_method']}): " + "; ".join(
                  f"{k} {v!r}" + (f" (predicted {pred[k][0]}-{pred[k][1]})" if k in pred else "")
                  for k, v in ms.items())
              + f"; launches a stage {per_stage} ({search}, and K9 in stats and epoch); "
              f"weights bitwise unchanged; {wall:.1f} s wall ({card})")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_sklearn(torch, card):
    """The sklearn adapter on the flagship (phase 21 of the module
    docstring), where scikit-learn imports: ``SomClusterer`` with no
    ``device`` (the card) against a bare ``XPySom``, bit for bit, with
    exact launches per call, and the host walls of ``fit`` beside the bare
    train + predict + QE, in turns. Returns the adapter's launches (none
    where scikit-learn is absent)."""
    from xpysom_dask_tpu_torch import XPySom
    from xpysom_dask_tpu_torch.ops import kernels

    try:
        from xpysom_dask_tpu_torch.sklearn import SomClusterer
    except ImportError as exc:
        print(f"sklearn: scikit-learn does not import on this machine ({exc}); not run: "
              "SomClusterer fit/predict/score/transform/inverse_transform on the flagship "
              "against a bare XPySom, their launches and walls")
        return {}

    f = FLAGSHIP
    X = _flagship_rows(f["n"], f["d"])
    n_chunks = f["n"] // f["chunk"]
    kw = dict(FLAGSHIP_KW, n_parallel=f["chunk"])
    walls = {"fit": [], "bare": []}
    launches = {}

    def counted(name, fn, want):
        kernels.reset_launch_counts()
        out = fn()
        counts = kernels.launch_counts()
        _expect_counts(f"sklearn {name}", counts, want)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out

    def bare():
        som = XPySom(f["x"], f["y"], f["d"], **kw).train(X, 2)
        return som, som.predict(X), som.quantization_error(X)

    def fit():
        return SomClusterer(f["x"], f["y"], num_epochs=2, **kw).fit(X)

    for turn in ("bare", "fit", "fit", "bare"):  # the first fit's launches counted
        t = {}
        if turn == "bare":
            som, labels, qe = _timed(torch, t, turn, bare)
        elif walls["fit"]:
            est = _timed(torch, t, turn, fit)
        else:
            est = _timed(torch, t, turn, lambda: counted(
                "fit", fit, {"bmu_argmin": 4 * n_chunks, "scatter_stats": 2 * n_chunks}))
        walls[turn].append(t[turn])
    w = som.get_weights().reshape(-1, f["d"])
    require(np.array_equal(est.cluster_centers_.view(np.int64), w.view(np.int64)),
            "sklearn: cluster_centers_ differ in bits from a bare XPySom's codebook")
    require(np.array_equal(est.labels_, labels), "sklearn: labels_ differ from predict")
    got = counted("predict", lambda: est.predict(X), {"bmu_argmin": n_chunks})
    require(np.array_equal(got, labels), "sklearn: predict(X) differs from XPySom.predict")
    score = counted("score", lambda: est.score(X), {"bmu_argmin": n_chunks})
    require(score == -qe, f"sklearn: score {score!r} is not -QE {-qe!r}")

    rows = min(8192, f["n"])
    dist = counted("transform", lambda: est.transform(X[:rows]), {})
    require(dist.shape == (rows, f["x"] * f["y"]), f"sklearn: transform shape {dist.shape}")
    x64, w64 = X[:rows].astype(np.float64), w.astype(np.float64)
    worst = 0.0
    for s in range(0, rows, 1024):
        xs = x64[s:s + 1024]
        sq = (xs * xs).sum(1)[:, None] + (w64 * w64).sum(1)[None, :] - 2.0 * xs @ w64.T
        # an f32 expansion of D terms errs by about (D + 2) u of its terms' size
        tol = (f["d"] + 2) * F32_U * ((xs * xs).sum(1)[:, None] + (w64 * w64).sum(1)[None, :]
                                      + 2.0 * np.abs(xs) @ np.abs(w64).T)
        err = np.abs(dist[s:s + 1024].astype(np.float64) ** 2 - np.maximum(sq, 0.0))
        worst = max(worst, float((err / tol).max()))
    require(worst <= 1.0, f"sklearn: transform's squares beyond the f32 bound ({worst:.3g} of it)")
    arg = dist.argmin(1)
    center = w.mean(0, dtype=np.float32).astype(np.float64)
    flips = np.nonzero(arg != labels[:rows])[0]
    _check_near_ties("sklearn transform argmin", flips, x64 - center, w64 - center,
                     arg, labels[:rows])
    require(np.array_equal(est.inverse_transform(labels), est.cluster_centers_[labels]),
            "sklearn: inverse_transform differs from cluster_centers_[labels]")
    try:
        est.inverse_transform([-1])
    except ValueError:
        pass
    else:
        raise RuntimeError("sklearn: inverse_transform(-1) did not raise")
    print(f"sklearn (flagship, 2 epochs, no device: the card): cluster_centers_ and labels_ "
          f"bitwise a bare XPySom's, predict bitwise, score == -QE ({score!r}), transform "
          f"{dist.shape} within {worst:.3g} of the f32 bound, its argmin = predict but "
          f"{len(flips)} near-ties, inverse_transform exact and -1 refused; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    print(f"sklearn walls (host clock, synchronized, s): fit {[round(t, 4) for t in walls['fit']]}"
          f", bare train + predict + QE {[round(t, 4) for t in walls['bare']]} (turns bare, "
          f"fit, fit, bare; predicted within 10%; {card})")
    return launches


# examples_torch's scripts that need scikit-learn (its data sets or adapter)
EXAMPLES_SKLEARN = ("handwritten_digits", "hexagonal_topology", "iris", "sklearn_pipeline",
                    "wine_table")
EXAMPLE_TIMEOUT_S = 120


def phase_examples(card, workdir):
    """Every ``examples_torch/*.py`` (phase 22 of the module docstring) in a
    subprocess of its own from the repository root, with no ``--device``
    (the card), killed at 120 s: exit 0 and ``device=cuda`` on the first
    line; the scripts that need scikit-learn are named and skipped where
    it does not import."""
    import importlib.util

    root = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(root, "examples_torch")
    names = sorted(n[:-3] for n in os.listdir(folder) if n.endswith(".py"))
    require(len(names) == 17, f"examples: {len(names)} scripts in {folder}")
    sklearn = importlib.util.find_spec("sklearn") is not None
    env = dict(os.environ, MPLBACKEND="Agg")
    t_phase = time.perf_counter()
    skipped = []
    for name in names:
        if name in EXAMPLES_SKLEARN and not sklearn:
            skipped.append(name)
            continue
        args = ["--file", os.path.join(workdir, "xsom_demo_torch.f32")] \
            if name == "large_scale_streaming" else []
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(folder, f"{name}.py"), *args],
                              cwd=root, env=env, capture_output=True, text=True,
                              timeout=EXAMPLE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        print(f"examples: {name}.py exit {proc.returncode} in {wall:.2f} s, first line "
              f"{lines[0] if lines else ''!r}, last {lines[-1][:80] if lines else ''!r}")
        require(proc.returncode == 0, f"examples: {name}.py failed:\n{proc.stderr[-2000:]}")
        require(lines[0] == "device=cuda", f"examples: {name}.py began {lines[0]!r}")
    if skipped:
        print(f"examples: scikit-learn does not import on this machine; not run: "
              f"{', '.join(skipped)}")
    print(f"examples: {len(names) - len(skipped)} scripts in {time.perf_counter() - t_phase:.1f} s "
          f"(predicted under 90 s; {card})")


# the search kernel (ptxas's name, as _kernel_name gives it; for the
# elementwise engine the prefix of its instances) behind each kernel of the
# record
_PTXAS_NAMES = {
    "bmu_argmin": "gemm_sm90_kernel <K1 ARGMIN>", "bmu_top2": "gemm_sm90_kernel <K2 TOP2>",
    "bmu_split3": "gemm_sm90_kernel <K3 SPLIT3>",
    "bmu_argmin_kb": "gemm_sm90_kernel <K1-kb KBLOCKED>", "bmu_highest": "bmu_highest_kernel",
    "bmu_manhattan": "tile_kernel <L1Term, search>", "bmu_norm_p_odd": "tile_kernel <PowTerm",
    "bmu_norm_p_frac": "tile_kernel <FracTerm", "manhattan_distance": "tile_kernel <L1Term, store>",
    "scatter_stats": "scatter_stats_kernel", "bmu_stats_fused": "fused_stats_kernel",
}


def _registers(name, ptxas):
    """A kernel's registers (the most of any instance) and spill bytes (all
    instances) from ptxas, for the kernels' record."""
    inst = [v for k, v in ptxas.items() if k.startswith(_PTXAS_NAMES[name])]
    require(inst, f"ptxas reported no instance of {name}")
    return {"registers": max(v[0] for v in inst), "spill_bytes": sum(v[1] + v[2] for v in inst)}


def main(argv):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke test of xpysom_dask_tpu_torch")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--te-pass-of", metavar="DIR",
                      help="only time the TE pass, with the package of the checkout in DIR")
    only.add_argument("--manhattan-epoch-of", metavar="DIR",
                      help="only time the manhattan epoch, with the package of the checkout in DIR")
    only.add_argument("--dist-cards", type=int, metavar="N",
                      help="only the distributed ranks' phase, N ranks on NCCL, one a card")
    ap.add_argument("--dist-worker", nargs=4, metavar=("RANK", "WORLD", "BACKEND", "DIR"),
                    help="run one rank of the distributed phase (started by the phase itself)")
    ap.add_argument("--grid-worker", nargs=4, metavar=("RANK", "WORLD", "BACKEND", "DIR"),
                    help="run one rank of the grid phase (started by the phase itself)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    other = args.te_pass_of or args.manhattan_epoch_of
    if other:
        sys.path.insert(0, os.path.abspath(other))
    try:
        import xpysom_dask_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2

    if args.dist_worker:
        rank, world, backend, store = args.dist_worker
        return dist_worker(int(rank), int(world), backend, store)
    if args.grid_worker:
        rank, world, backend, store = args.grid_worker
        return grid_worker(int(rank), int(world), backend, store)
    smi = phase_card(torch)
    if args.dist_cards:
        require(torch.cuda.device_count() >= args.dist_cards,
                f"--dist-cards {args.dist_cards}: {torch.cuda.device_count()} cards")
        phase_build()
        workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=_build_root(xpysom_dask_tpu_torch))
        try:
            phase_ranks(torch, smi, workdir, args.dist_cards, "nccl")
            phase_grid_ranks(torch, smi, workdir, args.dist_cards, "nccl")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    if other:
        root = os.path.dirname(os.path.dirname(os.path.abspath(xpysom_dask_tpu_torch.__file__)))
        require(root == os.path.abspath(other), f"the package came from {root}")
        phase_build()
        phase = phase_te_pass if args.te_pass_of else phase_manhattan_epoch
        phase(torch, smi, f"the tree in {other}")
        return 0
    ptxas = phase_build()
    timings, errs, bounds = phase_kernels(torch, smi)
    phase_feeds(torch, smi, ptxas)
    for phase in (phase_tile_kernels, phase_mode_kernels):
        t2, e2, b2 = phase(torch, smi)
        timings.update(t2)
        errs.update(e2)
        bounds.update(b2)
    data, kw, w3, counts = phase_main_path(torch)
    phase_te_pass(torch, smi)
    phase_determinism(torch, data, kw, w3)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=_build_root(xpysom_dask_tpu_torch))
    try:
        phase_checkpoint_and_pickle(torch, smi, data, kw, workdir)
        counts_paths = phase_split3_and_hex_paths(torch, data)
        del data
        counts_l1 = phase_manhattan_path(torch)
        phase_manhattan_epoch(torch, smi)
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
        for name, phase in (("bmu_argmin_kb", phase_kblock),
                            ("bmu_stats_fused", phase_fused_epoch)):
            launches[name], errs[name], timings[name], bounds[name] = phase(torch, smi)
        phase_streaming(torch, smi, workdir)
        phase_population(torch, smi, workdir)
        phase_distributed(torch, smi, workdir)
        phase_grid(torch, smi, workdir)
        # epoch_anatomy's and the adapter's launches (K1, K9, K5) add to
        # their kernels' counts, each counted just around its own calls
        for extra in (phase_anatomy(torch, smi), phase_sklearn(torch, smi)):
            for name, n in extra.items():
                launches[name] += n
        phase_examples(smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
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
                **_registers(name, ptxas),
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
    sys.exit(main(sys.argv[1:]))
