"""The PyTorch port's kernel modules against the JAX package's Pallas
kernels (run in interpret mode on the CPU). On CPU tensors each wrapper
runs its plain PyTorch version, which is what these tests hold against the
JAX kernels; the CUDA kernels themselves are checked against the same
plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu
from xpysom_dask_tpu.ops.pallas.stats import scatter_stats as jax_scatter_stats
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.distances import fp32_matmul
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb
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


def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(50, 4).astype(np.float32))
    w = torch.from_numpy(rng.rand(30, 4).astype(np.float32))
    cb = kb.PackedCodebook(w)
    kb.bmu_argmin(*cb.operands(x))
    kb.bmu_top2(*cb.operands(x))
    ks.scatter_stats(x, torch.ones(50), torch.zeros(50, dtype=torch.int32), 30)
    assert kernels.launch_counts() == {"bmu_argmin": 0, "bmu_top2": 0, "scatter_stats": 0}


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
    assert set(build.SOURCES) == {"bmu.cu", "stats.cu"}
    assert build.build_dir().parts[-2:] == ("build", "kernels")
