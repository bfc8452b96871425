"""The PyTorch port's kernel modules against the JAX package's Pallas
kernels (run in interpret mode on the CPU). On CPU tensors each wrapper
runs its plain PyTorch version, which is what these tests hold against the
JAX kernels; the CUDA kernels themselves are checked against the same
plain versions on the card by ``chip_smoke.py``."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu
from xpysom_dask_tpu.ops.pallas.stats import scatter_stats as jax_scatter_stats
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.distances import fp32_matmul
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke
from xpysom_dask_tpu_torch.ops.kernels import stats as ks


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _np_bf16(t):
    """A torch bf16 tensor as the numpy bf16 array jax uses."""
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


@pytest.mark.parametrize("n,xy,d", [(37, 91, 5), (300, 333, 7), (64, 2048, 64)])
def test_packed_operands_bitwise_equal_jax_splits(n, xy, d):
    rng = np.random.RandomState(n + d)
    x = (rng.randn(n, d) * 3).astype(np.float32)
    w = (rng.randn(xy, d) * 3).astype(np.float32)
    center = w.mean(0)
    xc, wc = x - center, w - center
    w_sq = (wc.astype(np.float64) ** 2).sum(1).astype(np.float32)

    a = kb.pack_samples(torch.from_numpy(xc))
    w_aug = kb.pack_codebook(torch.from_numpy(wc), torch.from_numpy(w_sq))

    # the JAX package's packed layout (ops/pallas/bmu.py, mode 'packed')
    xh, xl = pl_bmu._split_bf16(jnp.asarray(xc))
    wh, wl = pl_bmu._split_bf16(-2.0 * jnp.asarray(wc).T)
    s1, s2, s3 = pl_bmu._split3_bf16(jnp.asarray(w_sq)[None, :])
    ones = jnp.ones((n, 3), jnp.bfloat16)
    a_ref = jnp.concatenate([xh, xl, xh, ones], axis=1)
    w_ref = jnp.concatenate([wh, wh, wl, s1, s2, s3], axis=0)
    k = 3 * d + 3
    assert a.shape == (n, -(-k // 16) * 16)
    np.testing.assert_array_equal(_bits(_np_bf16(a[:, :k])), _bits(a_ref))
    np.testing.assert_array_equal(_bits(_np_bf16(w_aug[:k, :xy])), _bits(w_ref))
    # K padding and column padding are zeros
    assert not a[:, k:].float().any() and not w_aug[k:].float().any()
    assert not w_aug[:, xy:].float().any() and w_aug.shape[1] % 8 == 0


def test_splits_bitwise_equal_jax():
    rng = np.random.RandomState(0)
    # magnitudes whose split residuals stay normal floats: XLA's CPU
    # backend flushes subnormals to zero, torch keeps them
    v = np.concatenate(
        [rng.randn(4096) * 10.0 ** rng.randint(-20, 20, 4096), [0.0, -0.0, 1e38, 1e-30]]
    ).astype(np.float32)
    h, l = kb.split_bf16(torch.from_numpy(v))
    jh, jl = pl_bmu._split_bf16(jnp.asarray(v))
    np.testing.assert_array_equal(_bits(_np_bf16(h)), _bits(jh))
    np.testing.assert_array_equal(_bits(_np_bf16(l)), _bits(jl))
    s = kb.split3_bf16(torch.from_numpy(v))
    js = pl_bmu._split3_bf16(jnp.asarray(v))
    for mine, ref in zip(s, js):
        np.testing.assert_array_equal(_bits(_np_bf16(mine)), _bits(ref))
    # the 3-term split is exact
    total = sum(p.double() for p in s)
    np.testing.assert_array_equal(total.numpy(), v.astype(np.float64))


def _search(x, w, top2=False):
    """The port's packed search as the main path runs it (codebook-mean
    centering, packing, then the K1/K2 wrapper), and the center it used."""
    cb = kb.PackedCodebook(torch.from_numpy(w))
    fn = kb.bmu_top2 if top2 else kb.bmu_argmin
    return fn(*cb.operands(torch.from_numpy(x))), jnp.asarray(cb.center.numpy())


@pytest.mark.parametrize(
    "n,xy,d", [(300, 333, 7), (64, 25, 3), (1000, 91, 5), (256, 2048, 64)]
)
def test_plain_k1_matches_pallas_interpret(n, xy, d):
    rng = np.random.RandomState(xy)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    (i, v), center = _search(x, w)
    i_ref, v_ref = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, center=center
    )
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,xy,d", [(300, 333, 7), (256, 2048, 64), (64, 25, 3)])
def test_plain_k2_matches_pallas_interpret(n, xy, d):
    """Both indices equal the interpret kernel's, which equal a stable
    argsort of the float64 distances (tests/test_pallas.py pattern)."""
    rng = np.random.RandomState(7)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    got, center = _search(x, w, top2=True)
    ref = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, top2=True, center=center
    )
    dref = -2 * x.astype(np.float64) @ w.T.astype(np.float64) + (
        w.astype(np.float64) ** 2
    ).sum(1)
    order = np.argsort(dref, axis=1, kind="stable")[:, :2]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[0].numpy(), order[:, 0])
    np.testing.assert_array_equal(got[2].numpy(), order[:, 1])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-4)


def test_tie_fixture_first_index_and_duplicate_runner_up():
    """Duplicated codebook rows: the first index wins K1 and K2, and the
    duplicate is K2's runner-up (stable-argsort order), as in the JAX
    kernel across lane tiles."""
    x = np.zeros((4, 3), np.float32)
    x[1] = 5
    w = np.zeros((2100, 3), np.float32)
    w[7] = 5
    w[1500] = 5
    (i1, v1, i2, v2), center = _search(x, w, top2=True)
    (i0, _), _ = _search(x, w)
    ref = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, top2=True, center=center
    )
    assert i0.tolist() == i1.tolist() == [0, 7, 0, 0]
    assert i2.tolist() == [1, 1500, 1, 1]
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())  # duplicate: margin 0


@pytest.mark.parametrize(
    "n,d,xy,skew",
    [(3000, 16, 256, False), (1024, 8, 64, False), (10, 3, 5, False), (2000, 5, 91, True)],
)
def test_plain_k9_bitwise_equals_pallas_interpret(n, d, xy, skew):
    rng = np.random.RandomState(n)
    x = rng.randn(n, d).astype(np.float32)
    m = (rng.rand(n) > 0.1).astype(np.float32)
    if skew:  # long runs on a few nodes, as early training gives
        idx = np.minimum(rng.geometric(0.05, size=n) - 1, xy - 1).astype(np.int32)
    else:
        idx = rng.randint(xy, size=n).astype(np.int32)
    ref = jax_scatter_stats(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(idx), xy,
        interpret=True, return_acc=True,
    )
    got = ks.scatter_stats(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(idx), xy)
    assert got.shape == (xy, d + 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(ref)))


def test_plain_k9_ignores_out_of_range_and_all_masked():
    x = torch.ones((64, 4))
    acc = ks.scatter_stats(x, torch.zeros(64), torch.zeros(64, dtype=torch.int32), 16)
    assert float(acc.abs().sum()) == 0.0
    idx = torch.tensor([0, 1, 16, -1] * 16, dtype=torch.int32)
    acc = ks.scatter_stats(x, torch.ones(64), idx, 16)
    assert acc[:, -1].tolist() == [16.0, 16.0] + [0.0] * 14


@pytest.mark.parametrize("case", ["one node", "long run", "out of range", "odd D", "wide D"])
def test_plain_k9_bitwise_equals_pallas_interpret_under_skew(case):
    """K9's contract where csrc/stats.cu's grouping and column passes
    matter: every row on one node, one long run among uniform rows,
    negative and too-large indices (they contribute nothing; the JAX
    kernel, which clamps, gets them masked), an odd D and a D past one
    128-column pass."""
    rng = np.random.RandomState(len(case))
    n, d, xy = {"odd D": (400, 67, 50), "wide D": (200, 300, 30)}.get(case, (600, 6, 40))
    x = rng.randn(n, d).astype(np.float32)
    m = (rng.rand(n) > 0.1).astype(np.float32)
    idx = rng.randint(xy, size=n).astype(np.int32)
    if case == "one node":
        idx[:] = 17
    elif case == "long run":
        idx[rng.rand(n) < 0.6] = 3
    elif case == "out of range":
        idx = rng.randint(-xy, 2 * xy, size=n).astype(np.int32)
    valid = (idx >= 0) & (idx < xy)
    ref = jax_scatter_stats(
        jnp.asarray(x), jnp.asarray(m * valid), jnp.asarray(np.where(valid, idx, 0)), xy,
        interpret=True, return_acc=True,
    )
    got = ks.scatter_stats(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(idx), xy)
    assert got.shape == (xy, d + 1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(ref)))
    # int64 indices past 2^32 stay out of range
    got64 = ks.scatter_stats(torch.from_numpy(x), torch.from_numpy(m),
                             torch.from_numpy(np.where(valid, idx, idx.astype(np.int64) + (1 << 32))), xy)
    np.testing.assert_array_equal(_bits(got64.numpy()), _bits(np.asarray(ref)))


@pytest.mark.parametrize("xy,d,sms", [(16384, 64, 132), (91, 5, 132), (65536, 1023, 132),
                                      (1000, 300, 114), (1, 1, 8)])
def test_k9_plan_covers_every_node_once(xy, d, sms):
    """csrc/stats.cu's launch as the wrapper sizes it: block b owns nodes
    [b·nodes, (b+1)·nodes) ∩ [0, XY), so every node lies in exactly one
    range, within the kernel's node-id limit; column passes of at most 128
    cover the D + 1 columns. (The kernel's shared memory is sized and
    checked against the Hopper limit in csrc/stats.cu.)"""
    nodes, blocks, cols = ks.stats_plan(xy, d, sms)
    assert 1 <= nodes <= ks.MAX_NODES and 1 <= cols <= ks.MAX_COLS
    owner = np.repeat(np.arange(blocks), nodes)[:xy]
    assert len(owner) == xy and (blocks - 1) * nodes < xy <= blocks * nodes
    np.testing.assert_array_equal(np.bincount(owner, minlength=blocks) > 0, True)
    passes = -(-(d + 1) // ks.MAX_COLS)
    assert cols == min(d + 1, ks.MAX_COLS) and (passes - 1) * ks.MAX_COLS < d + 1
    if xy >= 2 * sms * ks.MAX_NODES:
        assert nodes == ks.MAX_NODES
    elif xy >= 2 * sms:
        assert blocks <= 2 * sms  # about two blocks per SM


def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(50, 4).astype(np.float32))
    w = torch.from_numpy(rng.rand(30, 4).astype(np.float32))
    cb = kb.PackedCodebook(w)
    kb.bmu_argmin(*cb.operands(x))
    kb.bmu_top2(*cb.operands(x))
    ks.scatter_stats(x, torch.ones(50), torch.zeros(50, dtype=torch.int32), 30)
    kb.PackedCodebook(w, "highest").argmin(x)
    ke.bmu_manhattan(x, w)
    ke.bmu_norm_p_odd(x, w, 3)
    ke.bmu_norm_p_frac(x, w, 1.5)
    kb.PackedCodebook(w, "split3").argmin(x)
    kernels.manhattan_distance(x, w)
    cb.argmin(x, kblock=128)
    kernels.bmu_stats_fused(x, w, torch.ones(50))
    assert kernels.launch_counts() == {
        **{name: 0 for name in kernels.KERNELS},
        **{f"{name}.{feed}": 0 for name in kernels.FED for feed in kernels.FEEDS}}
    assert set(kernels.KERNELS) == {
        "bmu_argmin", "bmu_top2", "scatter_stats", "bmu_highest", "bmu_manhattan",
        "bmu_norm_p_odd", "bmu_norm_p_frac", "bmu_split3", "manhattan_distance",
        "bmu_argmin_kb", "bmu_stats_fused",
    }


def test_wrappers_validate_inputs():
    a = torch.zeros((8, 16), dtype=torch.bfloat16)
    w = torch.zeros((16, 24), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        kb.bmu_argmin(a.float(), w, 24)
    with pytest.raises(ValueError, match="out of range"):
        kb.bmu_top2(a, w, 25)
    with pytest.raises(ValueError, match="expected"):
        kb.bmu_argmin(a, w[:8], 24)
    with pytest.raises(TypeError, match="float32"):
        ks.scatter_stats(torch.zeros((4, 2), dtype=torch.float64), torch.ones(4),
                         torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        ks.scatter_stats(torch.zeros((4, 2)), torch.ones(5), torch.zeros(4, dtype=torch.int32), 3)


def test_fp32_matmul_restores_the_callers_settings():
    prev = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def test_kernel_build_is_lazy():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    from xpysom_dask_tpu_torch.ops.kernels import build

    assert build._lib is None
    assert set(build.SOURCES) == {
        "gemm_sm90.cu", "stats.cu", "highest.cu", "elementwise.cu", "manhattan.cu",
        "fused_stats.cu",
    }
    assert build.HEADERS == ("tile_argmin.cuh", "sm90.cuh", "gemm_sm90.cuh", "stats.cuh")
    csrc = Path(kb.__file__).resolve().parents[2] / "csrc"
    for name in build.SOURCES + build.HEADERS:
        assert (csrc / name).is_file()
    # every C entry point the wrappers call has a signature and a source
    text = "".join((csrc / name).read_text() for name in build.SOURCES)
    for entry in build._SIGNATURES:
        assert f"int {entry}(" in text
    assert build.build_dir().parts[-2:] == ("build", "kernels")


# -- K4: the exact-f32 GEMM argmin (mode 'highest') ---------------------------


def _dot_band(x, w):
    """Per-row float64 near-tie band of an f32 dot search: twice the bound
    D * 2^-24 * sum_d |x_d||2 w_d| (two differently ordered sums)."""
    return 2 * 2 * x.shape[1] * 2.0**-24 * (np.abs(x).astype(np.float64) @ np.abs(2 * w).max(0))


def _assert_winners(got, want, d64, band):
    """Equal winners except rows whose two candidates are float64 near-ties
    within ``band`` (per row)."""
    rows = np.nonzero(got != want)[0]
    for r in rows:
        assert abs(d64[r, got[r]] - d64[r, want[r]]) <= band[r], (r, got[r], want[r])


@pytest.mark.parametrize("n,xy,d", [(300, 333, 7), (64, 25, 3), (1000, 91, 5), (256, 2048, 64),
                                    (256, 512, 64), (300, 91, 5)])
def test_plain_k4_matches_pallas_highest_interpret(n, xy, d):
    rng = np.random.RandomState(xy + 1)
    x = (rng.rand(n, d) * 2 + 1).astype(np.float32)  # offset data: centering matters
    w = (rng.rand(xy, d) * 2 + 1).astype(np.float32)
    cb = kb.PackedCodebook(torch.from_numpy(w), "highest")
    i, v = cb.argmin(torch.from_numpy(x))
    # on CPU tensors the K4 wrapper is its plain version, bit for bit
    i_p, v_p = kb.bmu_highest_plain(*cb.operands(torch.from_numpy(x)))
    assert torch.equal(i, i_p) and torch.equal(v.view(torch.int32), v_p.view(torch.int32))
    i_ref, v_ref = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode="highest",
        center=jnp.asarray(cb.center.numpy()),
    )
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    d64 = ((x64[:, None] - w64[None]) ** 2).sum(-1)
    xc, wc = x - cb.center.numpy(), w - cb.center.numpy()
    _assert_winners(i.numpy(), np.asarray(i_ref), d64, _dot_band(xc, wc))
    same = i.numpy() == np.asarray(i_ref)
    np.testing.assert_allclose(v.numpy()[same], np.asarray(v_ref)[same], rtol=2e-4, atol=1e-5)
    # the winner is the float64 winner up to the same band
    _assert_winners(i.numpy(), d64.argmin(1), d64, _dot_band(xc, wc))


def test_k4_tie_fixture_first_index_across_tiles():
    x = np.zeros((4, 3), np.float32)
    x[1] = 5
    w = np.zeros((2100, 3), np.float32)
    w[7] = w[1500] = 5
    for center in (True, False):
        cb = kb.PackedCodebook(torch.from_numpy(w), "highest", center=center)
        i, _ = cb.argmin(torch.from_numpy(x))
        assert i.tolist() == [0, 7, 0, 0]


@pytest.mark.parametrize("p", [2, 4, 6, 4.0])
@pytest.mark.parametrize("mode", ["highest", "packed"])
def test_norm_p_even_matches_pallas_interpret(p, mode):
    rng = np.random.RandomState(int(p))
    x = rng.rand(80, 5).astype(np.float32)
    w = rng.rand(200, 5).astype(np.float32)
    i, v = kb.bmu_norm_p_even(torch.from_numpy(x), torch.from_numpy(w), p=p, mode=mode)
    i_ref, v_ref = pl_bmu.bmu_norm_p_even(
        jnp.asarray(x), jnp.asarray(w), p=p, mode=mode, interpret=True
    )
    d64 = (np.abs(x[:, None].astype(np.float64) - w[None]) ** p).sum(-1)
    # the expansion's operands: phi (N, D(p+1)) and -psi/2 (XY, D(p+1))
    phi, psi_half, _ = (t.numpy() for t in kb.NormPEvenCodebook(
        torch.from_numpy(w), p, "highest").operands(torch.from_numpy(x)))
    band = _dot_band(phi, psi_half)
    if mode == "packed":  # the bf16 split's floor, 2^-17 of the same sum
        band = band + 2.0**-17 * (np.abs(phi) @ np.abs(2 * psi_half).max(0))
    _assert_winners(i.numpy(), np.asarray(i_ref), d64, band)
    _assert_winners(i.numpy(), d64.argmin(1), d64, band)
    if mode == "highest":
        same = i.numpy() == np.asarray(i_ref)
        np.testing.assert_allclose(v.numpy()[same], np.asarray(v_ref)[same], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), d64[np.arange(80), i.numpy()], rtol=2e-4, atol=1e-5)


def test_norm_p_even_rejects_bad_p_and_margin():
    x = torch.rand(4, 3)
    for p in (3, 2.5, 0, -2):
        with pytest.raises(ValueError, match="even"):
            kb.bmu_norm_p_even(x, x, p=p)
    with pytest.raises(ValueError, match="margin"):
        kb.bmu_norm_p_even(x, x, p=4, mode="margin")
    with pytest.raises(ValueError, match="serve"):
        kb.PackedCodebook(x, "fast")


# -- cosine glue over K1 / K4 ------------------------------------------------


@pytest.mark.parametrize("mode", ["packed", "highest"])
def test_bmu_cosine_matches_pallas_interpret(mode):
    rng = np.random.RandomState(5)
    x = (rng.randn(120, 6) * 2).astype(np.float32)
    w = (rng.randn(260, 6) * 2).astype(np.float32)
    w[7] = 0.0  # zero codebook row: distance 1
    x[3] = 0.0  # zero sample row: distance 1 everywhere, index 0
    i, v = kb.bmu_cosine(torch.from_numpy(x), torch.from_numpy(w), mode=mode)
    i_ref, v_ref = pl_bmu.bmu_cosine(jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-6)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    den = np.linalg.norm(x64, axis=1, keepdims=True) * np.linalg.norm(w64, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ref = 1 - np.nan_to_num((x64 @ w64.T) / den)
    np.testing.assert_array_equal(i.numpy(), ref.argmin(1))
    np.testing.assert_allclose(v.numpy(), ref.min(1), rtol=1e-4, atol=1e-5)
    assert i[3] == 0 and v[3] == 1.0


# -- K5-K7: the elementwise searches -----------------------------------------


@pytest.mark.parametrize("n,xy,d", [(150, 400, 9), (37, 91, 5), (64, 300, 24), (5, 7, 3)])
def test_plain_k5_bitwise_equals_pallas_interpret(n, xy, d):
    rng = np.random.RandomState(n + xy)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    if n == 5:  # every distance ties: index 0 wins
        x, w = np.zeros_like(x), np.ones_like(w)
    i, v = ke.bmu_manhattan(torch.from_numpy(x), torch.from_numpy(w))
    i_ref, v_ref = pl_bmu.bmu_manhattan(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(np.asarray(v_ref)))
    ref = np.abs(x[:, None].astype(np.float64) - w[None]).sum(-1)
    np.testing.assert_array_equal(i.numpy(), ref.argmin(1))


@pytest.mark.parametrize("p", [3, 5, 3.0, 1])
def test_plain_k6_matches_pallas_interpret(p):
    rng = np.random.RandomState(3)
    x = rng.rand(300, 24).astype(np.float32)
    w = rng.rand(517, 24).astype(np.float32)
    i, v = ke.bmu_norm_p_odd(torch.from_numpy(x), torch.from_numpy(w), p)
    i_ref, v_ref = pl_bmu.bmu_norm_p_odd(jnp.asarray(x), jnp.asarray(w), p=p, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-6)
    d64 = (np.abs(x[:, None].astype(np.float64) - w[None]) ** int(p)).sum(-1)
    np.testing.assert_array_equal(i.numpy(), d64.argmin(1))
    # exact duplicate codebook rows: the first index wins
    w_tie = np.vstack([w[:5], w[:5]])
    i_t, v_t = ke.bmu_norm_p_odd(torch.from_numpy(w[:5].copy()), torch.from_numpy(w_tie), p)
    assert i_t.tolist() == list(range(5)) and not v_t.any()


@pytest.mark.parametrize("p", [0.5, 1.5, 2.5, 3.7])
def test_plain_k7_matches_pallas_interpret(p):
    rng = np.random.RandomState(int(p * 10))
    x = rng.rand(300, 24).astype(np.float32)
    w = rng.rand(517, 24).astype(np.float32)
    i, v = ke.bmu_norm_p_frac(torch.from_numpy(x), torch.from_numpy(w), p)
    i_ref, v_ref = pl_bmu.bmu_norm_p_frac(jnp.asarray(x), jnp.asarray(w), p=p, interpret=True)
    i, i_ref = i.numpy(), np.asarray(i_ref)
    d64 = (np.abs(x[:, None].astype(np.float64) - w[None]) ** p).sum(-1)
    order = np.sort(d64, axis=1)
    margin = (order[:, 1] - order[:, 0]) / order[:, 0]
    assert not np.any((i != i_ref) & (margin > 1e-4))
    assert not np.any((i != d64.argmin(1)) & (margin > 1e-4))
    same = i == i_ref
    np.testing.assert_allclose(v.numpy()[same], np.asarray(v_ref)[same], rtol=1e-5)
    # zero distance: a sample equal to a codebook row wins with 0
    i_z, v_z = ke.bmu_norm_p_frac(torch.from_numpy(w[10:13].copy()), torch.from_numpy(w), p)
    assert i_z.tolist() == [10, 11, 12] and not v_z.any()
    # exact duplicate codebook rows: the first index wins
    w_tie = np.vstack([w[:5], w[:5]])
    i_t, _ = ke.bmu_norm_p_frac(torch.from_numpy(w[:5].copy()), torch.from_numpy(w_tie), p)
    assert i_t.tolist() == list(range(5))


def test_elementwise_wrappers_reject_bad_p_with_the_jax_messages():
    x = torch.rand(4, 3)
    for p in (4, 2.5, 0, -1):
        with pytest.raises(ValueError, match="positive odd integer"):
            ke.bmu_norm_p_odd(x, x, p)
        with pytest.raises(ValueError, match="positive odd integer"):
            pl_bmu.bmu_norm_p_odd(jnp.asarray(x.numpy()), jnp.asarray(x.numpy()), p=p,
                                  interpret=True)
    for p in (2, 2.0, -0.5, 0):
        with pytest.raises(ValueError, match="non-integer"):
            ke.bmu_norm_p_frac(x, x, p)
    with pytest.raises(TypeError, match="float32"):
        ke.bmu_manhattan(x.double(), x)
    with pytest.raises(ValueError, match=r"\(XY, D\)"):
        ke.bmu_manhattan(x, x[:, :2])
    with pytest.raises(ValueError, match="w_sq"):
        kb.bmu_highest(x, x, torch.zeros(3, 1))


def test_elementwise_codebook_routes_kernel_and_plain_alike():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(40, 6).astype(np.float32))
    w = torch.from_numpy(rng.rand(50, 6).astype(np.float32))
    for kind, p in (("manhattan", None), ("norm_p_odd", 3), ("norm_p_frac", 2.5)):
        cb = ke.ElementwiseCodebook(w, kind, p)
        a, b = cb.argmin(x), cb.argmin(x, use_kernels=False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
