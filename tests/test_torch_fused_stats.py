"""The port's fused BMU + statistics search (K10, ``bmu_stats_fused``)
against the JAX package's ``bmu_stats_fused`` in interpret mode on the CPU,
on tests/test_fused_stats.py's fixtures. On CPU tensors the wrapper runs
its plain version (K1's and K9's plain versions); the CUDA kernel is held
bitwise against K1 + K9 on the card by ``chip_smoke.py``."""

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
