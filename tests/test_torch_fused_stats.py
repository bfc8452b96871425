"""The port's fused BMU + statistics search (K10, ``bmu_stats_fused``)
against the JAX package's ``bmu_stats_fused`` in interpret mode on the CPU,
on tests/test_fused_stats.py's fixtures. On CPU tensors the wrapper runs
its plain version (K1's and K9's plain versions); the CUDA kernel is held
bitwise against K1 + K9 on the card by ``chip_smoke.py`` and
tests/test_torch_card.py. Here also: the launch plan (``fused_plan``) and
the laid-out operands the kernel reads, read back to the plain version."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xpysom_dask_tpu.ops.pallas.fused_stats import bmu_stats_fused as jax_fused
from xpysom_dask_tpu_torch import core
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
from xpysom_dask_tpu_torch.ops.kernels import fused_stats as kf
from xpysom_dask_tpu_torch.ops.kernels import stats as ks


def _bits(t):
    return t.numpy().view(np.int32)


@pytest.mark.parametrize(
    "n,d,xy,tiles",
    [
        (64, 4, 40, (16, 128)),     # ragged everything, multi-tile grid
        (300, 7, 256, (64, 128)),   # multi sample-tile x multi xy-tile
        (33, 3, 9, (8, 128)),       # xy smaller than one lane tile
    ],
)
def test_fused_matches_jax_interpret(n, d, xy, tiles):
    rng = np.random.RandomState(5)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    m = (rng.rand(n) > 0.2).astype(np.float32)
    xt, wt, mt = (torch.from_numpy(a) for a in (x, w, m))

    kernels.reset_launch_counts()
    idx, acc = kf.bmu_stats_fused(xt, wt, mt)
    assert kernels.launch_counts()["bmu_stats_fused"] == 0
    idx_ref, acc_ref = jax_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m),
                                 interpret=True, tiles=tiles)
    assert idx.dtype == torch.int32 and acc.shape == (xy, d + 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), rtol=1e-5, atol=1e-5)
    # acc is K9's on the port's winners, bit for bit, and the winners are
    # K1's on the uncentered packed operands
    np.testing.assert_array_equal(_bits(acc), _bits(ks.scatter_stats_plain(xt, mt, idx, xy)))
    cb = kb.PackedCodebook(wt, "packed", center=False)
    assert torch.equal(idx, kb.bmu_argmin_plain(*cb.operands(xt))[0])
    # a prebuilt uncentered codebook gives the same result
    idx2, acc2 = kf.bmu_stats_fused(xt, cb, mt)
    assert torch.equal(idx2, idx)
    np.testing.assert_array_equal(_bits(acc2), _bits(acc))


def test_fused_all_masked():
    rng = np.random.RandomState(0)
    x = rng.rand(24, 3).astype(np.float32)
    w = rng.rand(10, 3).astype(np.float32)
    m = np.zeros((24,), np.float32)
    idx, acc = kf.bmu_stats_fused(*(torch.from_numpy(a) for a in (x, w, m)))
    idx_ref, acc_ref = jax_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m),
                                 interpret=True, tiles=(8, 128))
    assert not acc.numpy().any() and not np.asarray(acc_ref).any()
    assert idx.shape == (24,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))


def test_fused_epoch_equals_k1_k9_epoch():
    """One epoch: the fused path's statistics plus ``_update_from_stats``
    give the codebook of the K1 + K9 composition bit for bit, and the
    statistics match the sum of the JAX kernel's chunk partials."""
    rng = np.random.RandomState(2)
    spec = core.SomSpec(6, 5, 4, sigma=2.0, sigmaN=0.5, learning_rate=0.5, learning_rateN=0.01)
    data, mask, _ = core.chunk_data(rng.rand(150, 4).astype(np.float32), 64)
    w = rng.rand(spec.xy, 4).astype(np.float32)
    wt, dt, mt = torch.from_numpy(w), torch.from_numpy(data), torch.from_numpy(mask)
    eta, sig = core._decays(spec, 1, 10, "cpu")
    new = {}
    for fused in (True, False):
        s, cnt = kf.epoch_stats(wt, dt, mt, fused=fused)
        new[fused] = core._update_from_stats(spec, wt, s, cnt, eta, sig)
        if fused:
            got = torch.cat([s, cnt[:, None]], dim=1).numpy()
    np.testing.assert_array_equal(_bits(new[True]), _bits(new[False]))
    want = sum(np.asarray(jax_fused(jnp.asarray(data[c]), jnp.asarray(w), jnp.asarray(mask[c]),
                                    interpret=True, tiles=(64, 128))[1])
               for c in range(data.shape[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[:, -1].sum() == 150.0


def test_fused_validation():
    x, w, m = torch.zeros((8, 4)), torch.zeros((16, 4)), torch.ones(8)
    with pytest.raises(ValueError, match="uncentered 'packed'"):
        kf.bmu_stats_fused(x, kb.PackedCodebook(w), m)
    with pytest.raises(ValueError, match="uncentered 'packed'"):
        kf.bmu_stats_fused(x, kb.PackedCodebook(w, "bf16", center=False), m)
    with pytest.raises(ValueError, match=r"mask \(N,\)"):
        kf.bmu_stats_fused(x, w, torch.ones(9))
    with pytest.raises(TypeError, match="float32"):
        kf.bmu_stats_fused(x.double(), w, m)


# (n, xy, d, sms): the flagship chunk (128 row blocks, one range of 63
# nodes per group of 256 threads), n = 65536 (512 row blocks: the
# persistent search wraps), xy = 200 x 100 and 200 x 200 (the latter 313
# ranges of 128 nodes: some groups take two), D = 200 (two column passes;
# 44-node ranges fit two groups' shared memory: 373 ranges), and a ragged
# chunk with fewer row blocks and nodes than blocks
PLANS = [(16384, 16384, 64, 132), (65536, 16384, 64, 132), (16384, 20000, 64, 132),
         (16384, 40000, 64, 132), (16384, 16384, 200, 132), (1000, 91, 5, 132)]


@pytest.mark.parametrize("n,xy,d,sms", PLANS)
def test_fused_plan(n, xy, d, sms):
    p = kf.fused_plan(n, xy, d, sms)
    assert p.grid == sms  # one 512-thread block per SM
    # phase 1: block b takes row blocks b, b + grid, ...; they cover n
    taken = sorted(rb for b in range(p.grid) for rb in range(b, p.row_blocks, p.grid))
    assert taken == list(range(p.row_blocks))
    assert (p.row_blocks - 1) * kb.GEMM_BM < n <= p.row_blocks * kb.GEMM_BM
    # phase 2: group g of block b takes ranges 2b + g, 2b + g + 2 grid, ...;
    # every node lies in exactly one
    assert 1 <= p.nodes <= ks.MAX_NODES
    cover = np.zeros(xy, np.int64)
    for b in range(p.grid):
        for g in range(kf.GROUPS):
            for r in range(kf.GROUPS * b + g, p.ranges, kf.GROUPS * p.grid):
                cover[r * p.nodes : min((r + 1) * p.nodes, xy)] += 1
    np.testing.assert_array_equal(cover, 1)
    assert (p.ranges - 1) * p.nodes < xy <= p.ranges * p.nodes
    # shared memory: both phases fit (each group's part rounded up to 128
    # bytes), within a Hopper block's 227 KB
    cols = min(d + 1, ks.MAX_COLS)
    group = -(-(4 * (-(-p.nodes * cols // 4) * 4) + ks.FIXED_BYTES) // 128) * 128
    assert group == kf.group_bytes(p.nodes, d)
    assert p.smem >= kf.K1_RING_BYTES and p.smem >= kf.GROUPS * group
    assert p.smem <= 227 * 1024
    # the ranges are as large as fit: one more node would not
    if p.nodes < min(ks.MAX_NODES, -(-xy // (kf.GROUPS * sms))):
        assert kf.GROUPS * kf.group_bytes(p.nodes + 1, d) > kf.MAX_SMEM


def test_fused_plan_constants_match_the_kernel_sources():
    """The plan's shared-memory terms are the kernel sources' own: K1's
    ring (four stages of a 128-row A chunk and a 128-row codebook chunk,
    64 deep, bf16), K9's fixed part past the sums, and K10's two groups of
    256 threads."""
    csrc = Path(kb.__file__).resolve().parents[2] / "csrc"
    gemm = (csrc / "gemm_sm90.cuh").read_text()
    stats = (csrc / "stats.cuh").read_text()
    fused = (csrc / "fused_stats.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    stages, bm, bk = (const(gemm, k) for k in ("STAGES", "BM", "BK"))
    assert kf.K1_RING_BYTES == stages * (bm + kb.K1_BN) * bk * 2 == 128 * 1024
    threads, floats, rows, nodes = (const(stats, k) for k in
                                    ("THREADS", "STAGE_FLOATS", "STAGE_ROWS", "MAX_NODES"))
    warps, cap = threads // 32, threads * const(stats, "ROWS_PER_THREAD")
    assert ks.FIXED_BYTES == (8 * floats + 8 * rows + 8 * cap + cap + 4 * warps * nodes
                              + 4 * (nodes + 1) + 4 * warps)
    assert ks.MAX_NODES == nodes and ks.MAX_COLS == const(stats, "MAX_COLS")
    assert kf.GROUPS == const(fused, "GROUPS")
    assert "return (xps_stats::smem_bytes(nodes, d) + 127) & ~127;" in fused
    # the flagship plan: 261 ranges of 63 nodes, about one per group (K9
    # takes 63-node ranges at two blocks per SM too)
    assert kf.fused_plan(16384, 16384, 64, 132) == kf.FusedPlan(132, 128, 63, 261, 218368)


def _unlay(flat, rows, k, trows):
    """The (rows, K16) operand read back from its layout ``flat``: the
    plain layout of 1 + each element's index says where each went."""
    k16 = -(-k // 16) * 16
    where = kb.lay_out_plain(torch.arange(1, rows * k16 + 1, dtype=torch.float64)
                             .reshape(rows, k16), trows)
    assert where.shape == flat.shape
    out = torch.zeros(rows * k16, dtype=flat.dtype)
    hit = where > 0
    out[where[hit].long() - 1] = flat[hit]
    return out.reshape(rows, k16)


def test_fused_laid_out_operands_match_jax_interpret():
    """The operands K10 reads on the card, made as its wrapper makes them
    (``PackedCodebook._on_card``: the samples packed and laid out by
    ``lay_out_samples(x, None, 'packed')``, the codebook by
    ``PackedCodebook.laid()[0]``), read back through the layout, are K1's
    packed operands bit for bit, and K1's and K9's plain versions on them
    give the JAX kernel's winners and statistics in interpret mode: 300
    rows (three 128-row blocks) against 200 nodes (two codebook tiles)."""
    n, d, xy = 300, 7, 200
    rng = np.random.RandomState(8)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    m = (rng.rand(n) > 0.2).astype(np.float32)
    xt, wt, mt = (torch.from_numpy(a) for a in (x, w, m))
    cb = kb.PackedCodebook(wt, "packed", center=False)
    seen = []
    cb._on_card(lambda *args: seen.append(args), xt, "packed", cb.laid()[0], xt, mt)
    (a_laid, w_laid, n_, k, xy_, *_), = seen
    assert (n_, k, xy_) == (n, 3 * d + 3, xy)
    a, w_aug, _ = cb.operands(xt)
    k16 = a.shape[1]
    assert torch.equal(_unlay(a_laid, n, k, kb.GEMM_BM).view(torch.int16), a.view(torch.int16))
    w_rows = _unlay(w_laid, xy, k, kb.K1_BN)
    assert torch.equal(w_rows.view(torch.int16), w_aug[:k16, :xy].T.contiguous().view(torch.int16))

    idx, _ = kb.bmu_argmin_plain(_unlay(a_laid, n, k, kb.GEMM_BM), w_rows.T, xy)
    acc = ks.scatter_stats_plain(xt, mt, idx, xy)
    idx_ref, acc_ref = jax_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(m),
                                 interpret=True, tiles=(128, 128))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), rtol=1e-5, atol=1e-5)
    i_f, acc_f = kf.bmu_stats_fused(xt, cb, mt)
    assert torch.equal(i_f, idx)
    np.testing.assert_array_equal(_bits(acc_f), _bits(acc))
