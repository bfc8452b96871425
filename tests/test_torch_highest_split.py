"""K4's three-pass TF32 split (mode ``'highest'``), emulated on the CPU.

The CUDA kernel (``xpysom_dask_tpu_torch/csrc/highest.cu``) splits each
operand as ``hi = tf32_rna(v)``, ``lo = tf32_rna(v - hi)`` and sums
``lo·hi + hi·lo + hi·hi`` on the tensor cores. Here the same split is
made with torch bit operations and the three products are summed in
float64, which isolates the split's share of the error envelope stated in
``csrc/highest.cu`` (``bmu.highest_envelope``). These are checks of the
envelope's arithmetic for ordinary finite values: the card's own split
(``cvt.rna.satfinite.tf32.f32``) and its f32 accumulation are held to the
whole envelope by ``chip_smoke.py``; on CPU tensors ``bmu_highest`` runs
its plain version (``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

# the split's share of K4's envelope: the dropped lo·lo term and the two
# residues, each at most 2^-22 |x_d||w_d| per product
SPLIT_ENVELOPE = 3 * 2.0**-22


def tf32_rna(v):
    """f32 ``v`` rounded to TF32 (11 significant bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds an ordinary finite
    value: add half of the 13 dropped bits to the magnitude, then clear
    them."""
    bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def split_tf32(v):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def emulated_distances(x, w, w_sq):
    """``-2·(lo·hi + hi·lo + hi·hi) + w_sq`` in float64 from the TF32
    splits of ``x`` (N, D) and ``w`` (XY, D)."""
    xh, xl = (t.double() for t in split_tf32(x))
    wh, wl = (t.double() for t in split_tf32(w))
    cross = xl @ wh.T + xh @ wl.T + xh @ wh.T
    return (-2.0 * cross + w_sq.double()[None, :]).numpy()


def _values(rng, scale):
    v = rng.randn(4096) * 10.0 ** rng.randint(-scale, scale + 1, 4096)
    return torch.from_numpy(np.concatenate([v, [0.0, -0.0, 1.0, -1.5]]).astype(np.float32))


@pytest.mark.parametrize("scale", [0, 6, 30])
def test_hi_keeps_eleven_bits_and_rounds_to_nearest(scale):
    v = _values(np.random.RandomState(scale), scale)
    hi, lo = split_tf32(v)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    # hi is a nearest 11-bit value: the residue is at most half an ulp
    assert (torch.abs(v.double() - hi.double()) <= 2.0**-11 * torch.abs(v.double())).all()
    assert torch.equal(torch.sign(hi), torch.sign(v))


@pytest.mark.parametrize("scale", [0, 6, 30])
def test_split_residue_within_two_to_minus_22(scale):
    v = _values(np.random.RandomState(scale + 1), scale)
    hi, lo = split_tf32(v)
    # v - hi is exact in f32
    assert torch.equal((v - hi).double(), v.double() - hi.double())
    resid = torch.abs(v.double() - hi.double() - lo.double())
    assert (resid <= 2.0**-22 * torch.abs(v.double())).all()


def _operands(case):
    """(x', w, w_sq) as the main path hands them to K4, seeded numpy data."""
    rng = np.random.RandomState(len(case))
    if case == "p=4 expansion":
        x = torch.from_numpy(rng.rand(96, 5).astype(np.float32))
        w = torch.from_numpy(rng.rand(150, 5).astype(np.float32))
        return kb.NormPEvenCodebook(w, 4, "highest").operands(x)
    n, xy, d = (256, 512, 64) if case == "flagship-like D=64" else (300, 91, 5)
    x = torch.from_numpy((rng.rand(n, d) * 2 + 1).astype(np.float32))
    w = torch.from_numpy((rng.rand(xy, d) * 2 + 1).astype(np.float32))
    return kb.PackedCodebook(w, "highest").operands(x)


CASES = ["flagship-like D=64", "ragged D=5", "p=4 expansion"]


def _exact(x, w, w_sq):
    x64, w64 = x.double().numpy(), w.double().numpy()
    d = -2.0 * x64 @ w64.T + w_sq.double().numpy()[None, :]
    mag = np.abs(x64) @ np.abs(2 * w64).T  # S per (row, node)
    return d, mag


@pytest.mark.parametrize("case", CASES)
def test_emulated_distances_inside_the_envelope(case):
    x, w, w_sq = _operands(case)
    got = emulated_distances(x, w, w_sq)
    exact, mag = _exact(x, w, w_sq)
    err = np.abs(got - exact)
    assert (err <= SPLIT_ENVELOPE * mag).all(), float((err / mag).max())
    # and far inside the whole envelope the card is held to
    assert (err <= kb.highest_envelope(x.shape[1]) * mag).all()


@pytest.mark.parametrize("case", CASES)
def test_emulated_winners_are_float64_winners_up_to_near_ties(case):
    x, w, w_sq = _operands(case)
    got = emulated_distances(x, w, w_sq).argmin(1)
    exact, mag = _exact(x, w, w_sq)
    want = exact.argmin(1)
    band = 2 * kb.highest_envelope(x.shape[1]) * mag.max(1)
    rows = np.nonzero(got != want)[0]
    for r in rows:
        assert exact[r, got[r]] - exact[r, want[r]] <= band[r], r
