"""The PyTorch port's precision modes ('bf16', 'split2', 'split3',
'margin') against the JAX package, on the CPU at small sizes: the packed
operands bit for bit, the plain K1/K2/K3 against the Pallas kernels in
interpret mode, the margin rescue on the JAX package's own fixtures
(tests/test_margin_bmu.py), the split2 raw-``w_sq`` rule
(tests/test_review_fixes.py), TE's mode mapping, and training through the
model. Inputs are made with numpy from fixed seeds and handed to both
packages."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpysom_dask_tpu import XPySom as JaxSom
from xpysom_dask_tpu import core as jcore
from xpysom_dask_tpu.ops.pallas import bmu as pl_bmu
from xpysom_dask_tpu_torch import XPySom
from xpysom_dask_tpu_torch import core as tcore
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _np_bf16(t):
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


def _f64(x, w):
    """float64 partial squared distances (N, XY)."""
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    return -2 * x64 @ w64.T + (w64**2).sum(1)


# -- operands ------------------------------------------------------------------


@pytest.mark.parametrize("n,xy,d", [(37, 91, 5), (64, 2048, 32)])
@pytest.mark.parametrize("mode,raw", [("bf16", False), ("split2", False), ("split2", True)])
def test_mode_operands_bitwise_equal_jax(n, xy, d, mode, raw):
    """The bf16 and split2 concatenations of ``bmu_euclidean`` (:772-813),
    the split2 ``‖w‖²`` from the rounded codebook or, raw, from the caller's
    operand split exactly. (The port sums the rounded norm over d in index
    order; XLA's CPU reduce does so in blocks of 32 rows, so the bitwise
    check stays at D <= 32.)"""
    rng = np.random.RandomState(n + d)
    xc = (rng.randn(n, d) * 3).astype(np.float32)
    wc = (rng.randn(xy, d) * 3).astype(np.float32)
    w_sq = (rng.rand(xy) * 5).astype(np.float32) if raw else (wc.astype(np.float64) ** 2).sum(
        1).astype(np.float32)

    a = kb.pack_samples(torch.from_numpy(xc), mode)
    given = torch.from_numpy(w_sq) if (raw or mode == "bf16") else None
    w_aug = kb.pack_codebook(torch.from_numpy(wc), given, mode)

    w2t = -2.0 * jnp.asarray(wc).T
    ones = jnp.ones((n, 3), jnp.bfloat16)
    if mode == "bf16":
        wsq = jnp.asarray(w_sq)[None, :]
        a_ref = jnp.concatenate([jnp.asarray(xc).astype(jnp.bfloat16), ones], axis=1)
        top = [w2t.astype(jnp.bfloat16)]
    else:
        wh, _ = pl_bmu._split_bf16(w2t)
        wsq = (jnp.asarray(w_sq)[None, :] if raw
               else 0.25 * jnp.sum(jnp.square(wh.astype(jnp.float32)), axis=0, keepdims=True))
        xh, xl = pl_bmu._split_bf16(jnp.asarray(xc))
        a_ref = jnp.concatenate([xh, xl, ones], axis=1)
        top = [wh, wh]
    w_ref = jnp.concatenate(top + list(pl_bmu._split3_bf16(wsq)), axis=0)
    k = a_ref.shape[1]
    assert a.shape == (n, -(-k // 16) * 16) and w_aug.shape[0] == a.shape[1]
    np.testing.assert_array_equal(_bits(_np_bf16(a[:, :k])), _bits(a_ref))
    np.testing.assert_array_equal(_bits(_np_bf16(w_aug[:k, :xy])), _bits(w_ref))
    assert not a[:, k:].float().any() and not w_aug[k:].float().any()
    assert not w_aug[:, xy:].float().any() and w_aug.shape[1] % 8 == 0


def test_split3_operands_bitwise_equal_jax():
    rng = np.random.RandomState(3)
    xc = (rng.randn(37, 5) * 3).astype(np.float32)
    wc = (rng.randn(91, 5) * 3).astype(np.float32)
    xh, xl = kb.split3_samples(torch.from_numpy(xc))
    wh, wl = kb.split3_codebook(torch.from_numpy(wc))
    jxh, jxl = pl_bmu._split_bf16(jnp.asarray(xc))
    jwh, jwl = pl_bmu._split_bf16(jnp.asarray(wc).T)
    for mine, ref in ((xh[:, :5], jxh), (xl[:, :5], jxl), (wh[:5, :91], jwh), (wl[:5, :91], jwl)):
        np.testing.assert_array_equal(_bits(_np_bf16(mine.contiguous())), _bits(ref))
    assert xh.shape == (37, 16) and wh.shape == (16, 96)
    assert not xh[:, 5:].float().any() and not wl[5:].float().any() and not wh[:, 91:].float().any()


# -- plain K1/K2/K3 against the Pallas kernels --------------------------------


@pytest.mark.parametrize("mode", ["bf16", "split2", "split3"])
@pytest.mark.parametrize("n,xy,d", [(300, 333, 7), (256, 2048, 64), (64, 25, 3)])
def test_plain_modes_match_pallas_interpret(mode, n, xy, d):
    rng = np.random.RandomState(xy + d)
    x = (rng.rand(n, d) * 2 + 1).astype(np.float32)  # offset data: centering matters
    w = (rng.rand(xy, d) * 2 + 1).astype(np.float32)
    cb = kb.PackedCodebook(torch.from_numpy(w), mode)
    i, v = cb.argmin(torch.from_numpy(x))
    center = jnp.asarray(cb.center.numpy())
    i_ref, v_ref = pl_bmu.bmu_euclidean(
        jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode, center=center
    )
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-5)
    if mode == "bf16":  # the top-2 form under the bf16 operands (TE's)
        got = cb.top2(torch.from_numpy(x))
        ref = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode,
                                   center=center, top2=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "split2", "split3", "margin"])
def test_mode_tie_fixture_first_index_across_tiles(mode):
    """Duplicated codebook rows in tiles 0 and 23: the first index wins."""
    x = np.zeros((4, 3), np.float32)
    x[1] = 5
    w = np.zeros((2100, 3), np.float32)
    w[7] = w[1500] = 5
    for center in (True, False):
        i, _ = kb.PackedCodebook(torch.from_numpy(w), mode, center=center).argmin(
            torch.from_numpy(x))
        assert i.tolist() == [0, 7, 0, 0]
    i_ref, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True, mode=mode)
    assert np.asarray(i_ref).tolist() == [0, 7, 0, 0]


def test_split3_sums_the_three_products_in_the_jax_order():
    """K3's plain version sums ``(hh + hl) + lh`` before ``-2·cross + w_sq``.
    The operands make each of the three dots exact in f32 (small integers
    and multiples of 2⁻⁹) while their sum rounds, so the values equal that
    order's bits and not another's."""
    rng = np.random.RandomState(9)
    ints = lambda *shape: torch.from_numpy(rng.randint(-128, 128, shape).astype(np.float32))
    fracs = lambda *shape: torch.from_numpy(rng.randint(-16, 16, shape).astype(np.float32) / 512)
    xh, xl = ints(50, 16).to(torch.bfloat16), fracs(50, 16).to(torch.bfloat16)
    wh, wl = ints(16, 40).to(torch.bfloat16), fracs(16, 40).to(torch.bfloat16)
    w_sq = torch.from_numpy(rng.rand(40).astype(np.float32))
    hh, hl, lh = ((a.double() @ b.double()).float() for a, b in ((xh, wh), (xh, wl), (xl, wh)))
    d = -2.0 * ((hh + hl) + lh) + w_sq[None, :]
    i, v = kb.bmu_split3_plain(xh, xl, wh, wl, w_sq, 40)
    np.testing.assert_array_equal(i.numpy(), torch.argmin(d, 1).numpy())
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(d.min(1).values.numpy()))
    other = -2.0 * (hh + (hl + lh)) + w_sq[None, :]
    assert not torch.equal(other, d)  # the fixture tells the two orders apart


def test_split3_wrapper_validates_operands():
    xh = torch.zeros((8, 16), dtype=torch.bfloat16)
    wh = torch.zeros((16, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="split pairs"):
        kb.bmu_split3(xh, xh[:4], wh, wh, torch.zeros(24), 24)
    with pytest.raises(ValueError, match="w_sq"):
        kb.bmu_split3(xh, xh, wh, wh, torch.zeros(20), 24)
    with pytest.raises(TypeError, match="bf16"):
        kb.bmu_split3(xh.float(), xh, wh, wh, torch.zeros(24), 24)


# -- margin ---------------------------------------------------------------------


def _margin(x, w, **kw):
    cb = kb.PackedCodebook(torch.from_numpy(w), "margin", **kw)
    i, v = cb.argmin(torch.from_numpy(x))
    center = None if cb.center is None else jnp.asarray(cb.center.numpy())
    return i.numpy(), v.numpy(), center


@pytest.mark.parametrize("n,xy,d", [(300, 333, 7), (256, 2048, 64), (8, 25, 1), (1000, 4100, 16)])
def test_margin_matches_jax_and_float64(n, xy, d):
    """The fixtures of tests/test_margin_bmu.py:32: indices equal the JAX
    margin search's and the float64 argmin; values are the exact f32
    winner values."""
    rng = np.random.RandomState(0)
    x = rng.rand(n, d).astype(np.float32)
    w = rng.rand(xy, d).astype(np.float32)
    i, v, center = _margin(x, w)
    i_ref, v_ref = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True,
                                        mode="margin", center=center)
    np.testing.assert_array_equal(i, np.asarray(i_ref))
    np.testing.assert_array_equal(i, _f64(x, w).argmin(1))
    np.testing.assert_allclose(v, np.asarray(v_ref), rtol=1e-5, atol=1e-5)
    c = center.astype(np.float64) if center is not None else 0
    np.testing.assert_allclose(v, _f64(x - c, w - c).min(1), rtol=1e-5, atol=1e-5)


def test_margin_near_ties_match_packed():
    """tests/test_margin_bmu.py:45: margins far below the bf16 envelope;
    margin equals packed exactly, and the raw bf16 pass flips far more."""
    rng = np.random.RandomState(1)
    d = 16
    base = rng.rand(64, d).astype(np.float32)
    w = np.repeat(base, 4, axis=0) + 2e-3 * rng.randn(256, d).astype(np.float32)
    x = (base[rng.randint(64, size=200)] + 2e-3 * rng.randn(200, d)).astype(np.float32)
    i_m, _, center = _margin(x, w)
    i_p, _ = kb.PackedCodebook(torch.from_numpy(w)).argmin(torch.from_numpy(x))
    i_b, _ = kb.PackedCodebook(torch.from_numpy(w), "bf16").argmin(torch.from_numpy(x))
    i_ref, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True,
                                    mode="margin", center=center)
    np.testing.assert_array_equal(i_m, i_p.numpy())
    # against the JAX margin search: equal but for float64 margins below
    # f32 resolution, where two f32 GEMMs summed in other orders part
    d64 = _f64(x, w)
    diff = np.nonzero(i_m != np.asarray(i_ref))[0]
    gaps = np.abs(d64[diff, i_m[diff]] - d64[diff, np.asarray(i_ref)[diff]])
    assert (gaps <= 2.0**-17 * (np.abs(x[diff]) @ np.abs(2 * w).max(0))).all(), gaps
    ref = d64.argmin(1)
    assert (i_b.numpy() != ref).sum() > 4 * (i_m != ref).sum()


def test_margin_first_index_ties():
    x = np.array([[1.0, 2.0], [0.0, 0.0]], dtype=np.float32)
    w = np.tile(np.array([[1.0, 2.0]], dtype=np.float32), (7, 1))
    assert _margin(x, w)[0].tolist() == [0, 0]


def test_margin_overflow_falls_back_to_a_full_packed_pass(monkeypatch):
    """tests/test_margin_bmu.py:91: every row ambiguous, capacity 8 << 128
    suspects: one packed pass over all rows, exact winners."""
    rng = np.random.RandomState(2)
    w_half = rng.rand(32, 8).astype(np.float32)
    w = np.concatenate([w_half, w_half])
    x = rng.rand(128, 8).astype(np.float32)
    rows = []
    real = kb.bmu_argmin
    monkeypatch.setattr(kb, "bmu_argmin", lambda a, *r: rows.append(a.shape[0]) or real(a, *r))
    with monkeypatch.context() as m:
        m.setattr(kb, "RESCUE_FRAC", 0.01)
        i, _, _ = _margin(x, w)
    np.testing.assert_array_equal(i, _f64(x, w).argmin(1))
    assert rows == [128]
    rows.clear()
    i, _, _ = _margin(x, w)  # the default capacity 16: still an overflow
    assert rows == [128]


def test_margin_rescue_row0_not_clobbered(monkeypatch):
    """tests/test_margin_bmu.py:255: row 0 is a suspect and the buffer has
    spare slots; the spare slots hold the dump index, so row 0 keeps its
    rescued winner (margin == packed)."""
    rng = np.random.RandomState(11)
    d = 16
    w = rng.rand(64, d).astype(np.float32)
    w[1] = w[0] + 3e-4 * rng.randn(d).astype(np.float32)
    x = np.concatenate([
        (w[0] + 0.5 * (w[1] - w[0]) + 1e-5 * rng.randn(1, d)).astype(np.float32),
        rng.rand(15, d).astype(np.float32),
    ])
    i_p, _ = kb.PackedCodebook(torch.from_numpy(w)).argmin(torch.from_numpy(x))
    i_m, _, center = _margin(x, w)  # 10 suspects over capacity 8: the full pass
    np.testing.assert_array_equal(i_m, i_p.numpy())
    i_ref, _ = pl_bmu.bmu_euclidean(jnp.asarray(x), jnp.asarray(w), interpret=True,
                                    mode="margin", center=center)
    np.testing.assert_array_equal(i_m, np.asarray(i_ref))
    # the rescue itself at the default capacity: 112 more rows that sit on
    # codebook rows 2..63, far outside the gate, make 128 rows whose buffer
    # of 16 holds every suspect; the gate flags row 0, the buffer has spare
    # slots, and only the buffer is re-ranked
    far = w[rng.randint(2, 64, size=112)] + 1e-3 * rng.randn(112, d)
    xs = torch.from_numpy(np.concatenate([x, far.astype(np.float32)]))
    cb = kb.PackedCodebook(torch.from_numpy(w), "margin")
    idx, val, _, val2 = kb.bmu_top2_plain(*cb.operands(xs))
    suspect = kb.margin_suspects(val, val2, xs - cb.center, cb.w)
    assert bool(suspect[0]) and 0 < int(suspect.sum()) < 16
    rows = []
    real = kb.bmu_argmin_plain
    monkeypatch.setattr(kb, "bmu_argmin_plain",
                        lambda a, *r: rows.append(a.shape[0]) or real(a, *r))
    i_r, _ = cb.argmin(xs, use_kernels=False)
    assert rows == [16]
    i_ps, _ = kb.PackedCodebook(torch.from_numpy(w)).argmin(xs)
    np.testing.assert_array_equal(i_r.numpy(), i_ps.numpy())
    np.testing.assert_array_equal(i_r.numpy()[:16], i_p.numpy())


def test_margin_cosine_matches_jax_and_float64():
    rng = np.random.RandomState(4)
    x = rng.randn(90, 12).astype(np.float32)
    w = rng.randn(70, 12).astype(np.float32)
    i, dist = kb.bmu_cosine(torch.from_numpy(x), torch.from_numpy(w), mode="margin")
    i_ref, d_ref = pl_bmu.bmu_cosine(jnp.asarray(x), jnp.asarray(w), interpret=True,
                                     mode="margin")
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    wn = w / np.linalg.norm(w, axis=1, keepdims=True)
    ref = 1 - xn.astype(np.float64) @ wn.T.astype(np.float64)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i.numpy(), ref.argmin(1))
    np.testing.assert_allclose(dist.numpy(), np.asarray(d_ref), rtol=1e-5, atol=1e-6)


def test_margin_rejected_for_norm_p():
    with pytest.raises(ValueError, match="margin"):
        kb.NormPEvenCodebook(torch.zeros((16, 4)), 4, "margin")
    with pytest.raises(ValueError, match="margin"):
        XPySom(4, 4, 8, device="cpu", activation_distance="norm_p",
               activation_distance_kwargs={"p": 4}, bmu_precision="margin")


# -- the modes through the model ---------------------------------------------------


def test_split2_raw_wsq_wrappers_match_highest():
    """tests/test_review_fixes.py:382: cosine and even-p norm_p ride the
    GEMM search with a semantic zero ``w_sq``, which split2 splits as
    given."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(((rng.rand(64, 16) - 0.5) * 4).astype(np.float32))
    w = torch.from_numpy(((rng.rand(32, 16) - 0.5) * 4).astype(np.float32))
    for fn, kw in ((kb.bmu_cosine, {}), (kb.bmu_norm_p_even, {"p": 4})):
        i_hi, _ = fn(x, w, mode="highest", **kw)
        i_s2, _ = fn(x, w, mode="split2", **kw)
        np.testing.assert_array_equal(i_s2.numpy(), i_hi.numpy())
        i_j, _ = (pl_bmu.bmu_cosine if fn is kb.bmu_cosine else pl_bmu.bmu_norm_p_even)(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), interpret=True, mode="split2", **kw)
        np.testing.assert_array_equal(i_s2.numpy(), np.asarray(i_j))


def test_split2_raw_wsq_honors_caller_w_sq():
    """tests/test_review_fixes.py:398: with ``w_sq = 0`` and rows of wildly
    different norms, raw split2 ranks by the pure dot ('highest'), and the
    rounded codebook's own norm changes winners."""
    rng = np.random.RandomState(3)
    w_np = ((rng.rand(24, 8) - 0.5) * 2).astype(np.float32)
    w_np *= (10.0 ** rng.randint(0, 3, size=(24, 1))).astype(np.float32)
    x = torch.from_numpy(((rng.rand(48, 8) - 0.5) * 2).astype(np.float32))
    w = torch.from_numpy(w_np)
    zeros = torch.zeros(24)
    i_hi, _ = kb.PackedCodebook(w, "highest", center=False, w_sq=zeros).argmin(x)
    i_raw, _ = kb.PackedCodebook(w, "split2", center=False, w_sq=zeros).argmin(x)
    i_old, _ = kb.PackedCodebook(w, "split2", center=False).argmin(x)
    np.testing.assert_array_equal(i_raw.numpy(), i_hi.numpy())
    assert (i_old.numpy() != i_hi.numpy()).any()


@pytest.mark.parametrize("mode", ["packed", "bf16", "split2", "split3", "highest", "margin"])
def test_te_mode_follows_te_fused_mode(mode):
    ours = XPySom(4, 4, 3, device="cpu", bmu_precision=mode)._spec
    ref = JaxSom(4, 4, 3, bmu_precision=mode)._spec
    assert tcore.te_fused_mode(ours) == jcore.te_fused_mode(ref)


def test_split2_low_d_warning():
    with pytest.warns(UserWarning, match="input_len=10 < 32"):
        XPySom(4, 4, 10, device="cpu", bmu_precision="split2")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        XPySom(4, 4, 32, device="cpu", bmu_precision="split2")


@pytest.mark.parametrize("mode", ["bf16", "split2", "split3", "margin"])
def test_training_under_each_mode_matches_jax(mode):
    """An 8×7 map trained 6 epochs under each mode against the JAX
    ``XPySom`` on the CPU (which searches in exact f32 there): split3 and
    margin within the golden tolerance rtol 1e-3, atol 1e-4. split2 (at
    D = 32: below it warns of map collapse) solves the problem for the
    bf16-rounded codebook, so on this near-tie-dense data a quarter of the
    winners part from the exact ones within six epochs: it has to agree
    at the start (> 0.99 of winners) and in QE (1e-3 relative). bf16 only
    has to lower QE and land within 5% of JAX's."""
    d = 32 if mode == "split2" else 10
    rng = np.random.RandomState(6)
    data = (rng.rand(1200, d) + 0.1).astype(np.float32)
    ours = XPySom(8, 7, d, sigma=2.5, random_seed=9, device="cpu", bmu_precision=mode)
    ref = JaxSom(8, 7, d, sigma=2.5, random_seed=9, bmu_precision=mode)
    qe0 = ours.quantization_error(data)
    assert np.mean(ours.predict(data) == ref.predict(data)) > 0.99
    ours.train(data, 6)
    ref.train(data, 6)
    qe, qe_ref = ours.quantization_error(data), ref.quantization_error(data)
    if mode == "bf16":
        assert qe < qe0 and abs(qe - qe_ref) / qe_ref < 0.05, (qe0, qe, qe_ref)
    elif mode == "split2":
        assert qe < qe0 and abs(qe - qe_ref) / qe_ref < 1e-3, (qe0, qe, qe_ref)
    else:
        np.testing.assert_allclose(ours.get_weights(), ref.get_weights(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(qe, qe_ref, rtol=1e-5)
    assert 0.0 <= ours.topographic_error(data) <= 1.0


@pytest.mark.parametrize(
    "kw", [{"bmu_precision": "split3"}, {"topology": "hexagonal"}, {"bmu_precision": "margin"}],
    ids=["split3", "hexagonal", "margin"],
)
def test_from_numpy_carries_a_jax_codebook(kw):
    """A JAX-trained codebook moves into the port under the mode or
    topology, and both packages give the same winners."""
    rng = np.random.RandomState(8)
    data = rng.rand(250, 6).astype(np.float32)
    ref = JaxSom(6, 6, 6, random_seed=5, **kw)
    ref.train(data, 4)
    ours = XPySom.from_numpy(ref._weights, random_seed=5, device="cpu", **kw)
    assert ours._bmu_precision == ref._bmu_precision and ours.topology == ref.topology
    assert ours.winner(data) == ref.winner(data)
