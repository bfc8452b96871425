"""The port's K-blocked GEMM-form search (K1-kb, ``bmu_argmin_kb`` through
``PackedCodebook.argmin(kblock=)``) against the JAX package's
``bmu_euclidean(kblock=)`` in interpret mode on the CPU. On CPU tensors the
wrapper runs its plain version; the CUDA kernel is checked against the
same plain version on the card by ``chip_smoke.py``."""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu
from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb


@lru_cache(maxsize=None)
def _fixture(n, xy, d, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(n, d).astype(np.float32), rng.rand(xy, d).astype(np.float32)


@lru_cache(maxsize=None)
def _jax(n, xy, d, seed, mode, kblock):
    """The JAX search on the port's centering (the codebook mean)."""
    x, w = _fixture(n, xy, d, seed)
    center = jnp.asarray(kb.PackedCodebook(torch.from_numpy(w), mode).center.numpy())
    i, v = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode, kblock=kblock, center=center
    )
    return np.asarray(i), np.asarray(v)


@pytest.mark.parametrize("mode", ["packed", "bf16"])
@pytest.mark.parametrize("kblock", [128, 512])
def test_kblock_matches_jax_kblocked_and_2d(mode, kblock):
    """As tests/test_pallas.py's K-blocked test, at (120, 384) x (500, 384):
    the port's winners equal JAX K1-kb's and the JAX 2-D kernel's, its
    values JAX K1-kb's within 1e-6; under packed the winners are the
    float64 argmin."""
    x, w = _fixture(120, 500, 384, 7)
    i, v = kb.PackedCodebook(torch.from_numpy(w), mode).argmin(
        torch.from_numpy(x), kblock=kblock)
    i_kb, v_kb = _jax(120, 500, 384, 7, mode, kblock)
    i_2d, _ = _jax(120, 500, 384, 7, mode, None)
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), i_kb)
    np.testing.assert_array_equal(i.numpy(), i_2d)
    np.testing.assert_allclose(v.numpy(), v_kb, rtol=1e-6, atol=1e-6)
    if mode == "packed":
        ref = (-2 * x.astype(np.float64) @ w.T.astype(np.float64)
               + (w.astype(np.float64) ** 2).sum(1)).argmin(1)
        np.testing.assert_array_equal(i.numpy(), ref)


@pytest.mark.parametrize("mode", ["packed", "bf16"])
def test_kblock_ragged_matches_jax(mode):
    """Ragged N and XY, and K (3·200 + 3 = 603 packed) cut into five
    128-deep slabs with zero padding."""
    x, w = _fixture(37, 91, 200, 3)
    i, v = kb.PackedCodebook(torch.from_numpy(w), mode).argmin(torch.from_numpy(x), kblock=128)
    i_kb, v_kb = _jax(37, 91, 200, 3, mode, 128)
    np.testing.assert_array_equal(i.numpy(), i_kb)
    np.testing.assert_allclose(v.numpy(), v_kb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["packed", "bf16"])
@pytest.mark.parametrize("kblock", [128, 512])
def test_kblock_plain_matches_k1_plain(mode, kblock):
    """K1-kb's plain version against K1's on the same operands: the slab
    sums reassociate only the f32 accumulation."""
    x, w = _fixture(120, 500, 384, 7)
    a, w_aug, xy = kb.PackedCodebook(torch.from_numpy(w), mode).operands(torch.from_numpy(x))
    i, v = kb.bmu_argmin_kb_plain(a, w_aug, xy, kblock)
    i1, v1 = kb.bmu_argmin_plain(a, w_aug, xy)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    np.testing.assert_allclose(v.numpy(), v1.numpy(), rtol=1e-6, atol=1e-6)
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    kernels.reset_launch_counts()
    i2, v2 = kb.bmu_argmin_kb(a, w_aug, xy, kblock)
    assert torch.equal(i2, i) and torch.equal(v2, v)
    assert kernels.launch_counts()["bmu_argmin_kb"] == 0


def test_kblock_pads_k_with_zeros():
    """K is zero-padded to a multiple of kblock: K = 208 → 256 under 128."""
    x, w = _fixture(20, 30, 64, 1)
    a, w_aug, xy = kb.PackedCodebook(torch.from_numpy(w)).operands(torch.from_numpy(x))
    assert a.shape[1] == 208
    pa, pw = kb._pad_k(a, w_aug, 128)
    assert pa.shape == (20, 256) and pw.shape == (256, w_aug.shape[1])
    assert torch.equal(pa[:, :208], a) and not pa[:, 208:].float().any()
    assert torch.equal(pw[:208], w_aug) and not pw[208:].float().any()
    assert kb._pad_k(pa, pw, 128)[0] is pa


def test_kblock_validation_matches_jax():
    """The three refusals, with the JAX package's messages."""
    xj, wj = jnp.zeros((8, 4)), jnp.zeros((16, 4))
    x, w = torch.zeros((8, 4)), torch.zeros((16, 4))
    with pytest.raises(ValueError, match="kblock.*requires mode"):
        pl_bmu.bmu_euclidean(xj, wj, interpret=True, mode="highest", kblock=128)
    for mode in ("highest", "split3", "split2", "margin"):
        with pytest.raises(ValueError, match="kblock.*requires mode"):
            kb.PackedCodebook(w, mode).argmin(x, kblock=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        pl_bmu.bmu_euclidean(xj, wj, interpret=True, mode="packed", kblock=100)
    for bad in (100, 0, -128):
        with pytest.raises(ValueError, match="multiple of 128"):
            kb.PackedCodebook(w).argmin(x, kblock=bad)
        with pytest.raises(ValueError, match="multiple of 128"):
            kb.PackedCodebook(w).argmin(x, use_kernels=False, kblock=bad)
    a, w_aug, xy = kb.PackedCodebook(w).operands(x)
    with pytest.raises(ValueError, match="multiple of 128"):
        kb.bmu_argmin_kb(a, w_aug, xy, 100)
    with pytest.raises(ValueError, match="top2"):
        pl_bmu.bmu_euclidean(xj, wj, interpret=True, top2=True, kblock=128)
    for mode in ("packed", "bf16"):
        with pytest.raises(ValueError, match="top2"):
            kb.PackedCodebook(w, mode).top2(x, kblock=128)
    # no kblock: the searches run as before
    assert kb.PackedCodebook(w).top2(x)[0].shape == (8,)
