"""The operand layout of the wgmma searches (K1, K3, and K2 and K1-kb on
K1's operands, ``csrc/gemm_sm90.cu``) on the CPU: the layout pre-pass's plain version
(``lay_out_plain``, which ``lay_out`` runs on CPU tensors) against an
independent element-wise index map, un-laid back to ``pack_samples`` /
``pack_codebook`` and ``split3_samples`` / ``split3_codebook`` bit for
bit for every operand set K1 and K3 serve, with ragged rows, node counts
that are not a multiple of the tile width and depths that are not a
multiple of the chunk depth. The kernel's reads are emulated from the laid
bytes through wgmma's no-swizzle K-major descriptor (start address, LBO,
SBO), with the kernel's own pointer arithmetic for resident and streamed
A, and the search it feeds is held against the plain versions; K1-kb's
slab schedule is emulated on the same reads. K2's top-2 finish is
emulated in tests/test_torch_gemm_finish.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

BK = kb.GEMM_BK


def _offset(r, k, trows, k16):
    """Element offset of (row r, depth k) in the laid array: tile, chunk of
    depth dc, 8-row group, core matrix along K, row in it, value in row."""
    tile, rr = r // trows, r % trows
    c, kk = k // BK, k % BK
    dc = np.minimum(BK, k16 - c * BK)
    return (tile * trows * k16 + trows * c * BK + (rr // 8) * 8 * dc + (kk // 8) * 64
            + (rr % 8) * 8 + kk % 8)


def _unlay(flat, rows, k, trows):
    """The (rows, k) operand read back from ``flat`` through the index map."""
    k16 = -(-k // 16) * 16
    r, c = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    return flat[torch.from_numpy(_offset(r, c, trows, k16).reshape(-1))].reshape(rows, k)


def _bits(t):
    return t.contiguous().view(torch.int16)


def _check_laid(t, trows):
    """lay_out(t) is a bijection of the padded operand: every position is
    hit once, the operand reads back bit for bit, the padding is zero."""
    rows, k = t.shape
    k16 = -(-k // 16) * 16
    flat = kb.lay_out(t, trows)
    padded = -(-rows // trows) * trows
    assert flat.shape == (padded * k16,) and flat.dtype == torch.bfloat16
    assert torch.equal(kb.lay_out_plain(t, trows).view(torch.int16), flat.view(torch.int16))
    r, c = np.meshgrid(np.arange(padded), np.arange(k16), indexing="ij")
    off = _offset(r, c, trows, k16).reshape(-1)
    np.testing.assert_array_equal(np.sort(off), np.arange(padded * k16))
    assert torch.equal(_bits(_unlay(flat, rows, k, trows)), _bits(t))
    inside = (r < rows) & (c < k)
    assert not flat[torch.from_numpy(off[~inside.reshape(-1)])].float().any()
    return flat


def _data(n, xy, d, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, d) * 3).astype(np.float32))
    w = torch.from_numpy((rng.randn(xy, d) * 3).astype(np.float32))
    return x, w


# (n, xy, d): ragged rows, node counts off the tile widths, K = 3d + 3
# padded to 16 off the chunk depth (18 -> 32, 195 -> 208, 963 -> 976)
SHAPES = [(37, 91, 5), (300, 333, 64), (129, 200, 320)]


@pytest.mark.parametrize("n,xy,d", SHAPES)
@pytest.mark.parametrize("mode", ["packed", "bf16", "split2", "margin"])
def test_k1_operands_read_back_bitwise(n, xy, d, mode):
    x, w = _data(n, xy, d, n + d)
    cb = kb.PackedCodebook(w, mode)
    a, w_aug, _ = cb.operands(x)
    if mode == "margin":
        # K2's first pass reads the bf16 operands, its codebook laid()[1]
        _check_laid(a, kb.GEMM_BM)
        laid = _check_laid(w_aug[:, :xy].T, kb.K1_BN)
        assert torch.equal(laid.view(torch.int16), cb.laid()[1].view(torch.int16))
        # the re-rank's packed operands
        a, w_aug = kb.pack_samples(cb._centered(x)), cb.w_aug_packed
    _check_laid(a, kb.GEMM_BM)
    laid = _check_laid(w_aug[:, :xy].T, kb.K1_BN)
    assert torch.equal(laid.view(torch.int16), cb.laid()[0].view(torch.int16))


@pytest.mark.parametrize("n,xy,d", SHAPES)
@pytest.mark.parametrize("kind", ["cosine", "norm_p"])
@pytest.mark.parametrize("mode", ["packed", "bf16"])
def test_k1_cosine_and_norm_p_operands_read_back_bitwise(n, xy, d, kind, mode):
    x, w = _data(n, xy, min(d, 80), n + 1)
    if kind == "cosine":
        cb = kb.cosine_codebook(w, mode)
        a, w_aug, _ = cb.operands(x)
    else:
        ncb = kb.NormPEvenCodebook(w, 4, mode)
        cb = ncb._gemm
        a, w_aug, _ = ncb.operands(x)
    _check_laid(a, kb.GEMM_BM)
    laid = _check_laid(w_aug[:, :xy].T, kb.K1_BN)
    assert torch.equal(laid.view(torch.int16), cb.laid()[0].view(torch.int16))


@pytest.mark.parametrize("n,xy,d", SHAPES)
def test_k3_operands_read_back_bitwise(n, xy, d):
    x, w = _data(n, xy, d, n + 2)
    cb = kb.PackedCodebook(w, "split3")
    xh, xl, wh, wl, _, _ = cb.operands(x)
    for t in (xh, xl):
        _check_laid(t, kb.GEMM_BM)
    for t, laid in zip((wh, wl), cb.laid()):
        mine = _check_laid(t[:, :xy].T, kb.K3_BN)
        assert torch.equal(mine.view(torch.int16), laid.view(torch.int16))


def test_layout_takes_any_strides():
    x, _ = _data(70, 1, 40, 3)
    t = x.to(torch.bfloat16)
    assert torch.equal(kb.lay_out(t.T.contiguous().T, 64).view(torch.int16),
                       kb.lay_out(t, 64).view(torch.int16))
    with pytest.raises(TypeError, match="bf16"):
        kb.lay_out(x, 64)


def _desc_read(image, start, lbo, sbo, rows):
    """The (rows, 16) bf16 operand a no-swizzle K-major wgmma descriptor
    (start address, LBO, SBO in bytes) reads from the shared-memory image
    (an int16 array indexed in bf16 units): row i, value k at start +
    (i // 8)·SBO + (k // 8)·LBO + (i % 8)·16 + (k % 8)·2 bytes."""
    i, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    byte = start + (i // 8) * sbo + (k // 8) * lbo + (i % 8) * 16 + (k % 8) * 2
    return image[byte // 2]


def _emulated_k1(a, w_aug, xy, resident, kblock=None):
    """K1's addressing on the laid operands, in numpy: the producer's bulk
    copies into the resident A tile and the ring, the consumers' descriptors
    per 16-deep step, and the f32 accumulation of each tile; returns the
    (N, XY) distances the finish ranks. With ``kblock``, K1-kb's slab
    schedule: a slab closes at its last 64-deep chunk or at K's end, its
    product (float64 here) is rounded to f32 and added in f32, in order,
    into a running sum that starts from 0.0; returns that sum."""
    bm, bn, lbo = kb.GEMM_BM, kb.K1_BN, 128
    n, k = a.shape
    k16 = -(-k // 16) * 16
    nk, ntiles = -(-k16 // BK), -(-xy // bn)
    ga = kb.lay_out(a, bm).view(torch.int16).numpy()
    gw = kb.lay_out(w_aug[:, :xy].T, bn).view(torch.int16).numpy()
    out = np.zeros((-(-n // bm) * bm, ntiles * bn), np.float64)
    run = np.zeros(out.shape, np.float32)
    for blk in range(-(-n // bm)):
        a_tile = blk * bm * k16
        smem_a = ga[a_tile : a_tile + bm * k16] if resident else None
        for it in range(nk * ntiles):
            tile, c = divmod(it, nk)
            dc = min(BK, k16 - c * BK)
            sbo = 16 * dc
            stage_b = gw[tile * bn * k16 + bn * c * BK:][: bn * dc]
            stage_a = ga[a_tile + bm * c * BK:][: bm * dc]
            for wg in range(2):
                if resident:
                    img, base = smem_a, bm * c * BK * 2 + wg * 8 * sbo
                else:
                    img, base = stage_a, wg * 8 * sbo
                for ks in range(dc // 16):
                    off = ks * 2 * lbo
                    av = _desc_read(img, base + off, lbo, sbo, 64)
                    bv = _desc_read(stage_b, off, lbo, sbo, bn)
                    to_f = lambda v: torch.from_numpy(v.astype(np.int16)).view(
                        torch.bfloat16).double().numpy()
                    rows = slice(blk * bm + wg * 64, blk * bm + wg * 64 + 64)
                    out[rows, tile * bn : (tile + 1) * bn] += to_f(av) @ to_f(bv).T
            if kblock and (c == nk - 1 or c % (kblock // BK) == kblock // BK - 1):
                cell = (slice(blk * bm, blk * bm + bm), slice(tile * bn, (tile + 1) * bn))
                run[cell] += out[cell].astype(np.float32)
                out[cell] = 0.0
    return (run if kblock else out)[:n, :xy]


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("n,xy,d", [(150, 140, 5), (130, 129, 64)])
def test_emulated_kernel_reads_compute_the_plain_product(n, xy, d, resident):
    x, w = _data(n, xy, d, 7)
    a, w_aug, _ = kb.PackedCodebook(w).operands(x)
    got = _emulated_k1(a, w_aug, xy, resident)
    want = a.double() @ w_aug[:, :xy].double()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kblock", [128, 512])
@pytest.mark.parametrize("n,xy,d", SHAPES)
def test_emulated_slab_schedule_matches_the_kblocked_plain(n, xy, d, kblock):
    """K1-kb's slabs on the unpadded laid operands (K = 18, 195, 963 padded
    to 16 only): the same values bit for bit as the schedule on the
    operands padded to ``kblock`` and as the slab association computed
    from the unlaid padded operands (each slab's float64 product rounded
    to f32, added in f32 from 0.0); the winners of ``bmu_argmin_kb_plain``
    (which pads K to ``kblock``). Its values are f32 matmuls of the slabs,
    whose summation order the CPU library picks (4e-5 relative at K = 195),
    so they are held to the f32 accumulation bound 2·K·2⁻²⁴·Σ|A||W|."""
    x, w = _data(n, xy, d, n + d + 5)
    a, w_aug, _ = kb.PackedCodebook(w).operands(x)
    got = _emulated_k1(a, w_aug, xy, False, kblock)
    pa, pw = kb._pad_k(a, w_aug, kblock)
    padded = _emulated_k1(pa, pw, xy, False, kblock)
    np.testing.assert_array_equal(padded.view(np.int32), got.view(np.int32))
    ref = np.zeros((n, xy), np.float32)
    for k0 in range(0, pa.shape[1], kblock):
        ref += (pa[:, k0 : k0 + kblock].double() @ pw[k0 : k0 + kblock, :xy].double()
                ).numpy().astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    i_p, v_p = kb.bmu_argmin_kb_plain(a, w_aug, xy, kblock)
    win = got.argmin(1)
    np.testing.assert_array_equal(win, i_p.numpy())
    mag = (a.double().abs() @ w_aug[:, :xy].double().abs()).numpy()[np.arange(n), win]
    assert (np.abs(got.min(1) - v_p.numpy()) <= 2 * a.shape[1] * 2.0**-24 * mag).all()


def test_layout_constants_match_the_kernel_source():
    src = (Path(kb.__file__).resolve().parents[2] / "csrc" / "gemm_sm90.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BM") == kb.GEMM_BM and const("BK") == kb.GEMM_BK
    assert const("RESIDENT_K") == kb.RESIDENT_K
    assert const("REGISTER_K") == kb.REGISTER_K
    # K1's and K2's feeds, as the C entries take them
    feeds = dict(re.findall(r"(FEED_\w+) = (\d+)", src))
    assert feeds == {"FEED_STREAMED": str(kb.FEED_STREAMED), "FEED_PAIRS": str(kb.FEED_PAIRS),
                     "FEED_REGISTERS": str(kb.FEED_REGISTERS)}
    # every variant's tile width: K2 and K1-kb read K1's codebook layout
    widths = dict(re.findall(r"struct Cfg<Search::(\w+)> : Shape<(\d+),", src))
    assert widths == {"ARGMIN": str(kb.K1_BN), "SPLIT3": str(kb.K3_BN),
                      "TOP2": str(kb.K1_BN), "KBLOCKED": str(kb.K1_BN)}
    # K1 and K2 on the deep feeds, and K1's feed alone: tiles of WIDE_BN
    # rows made of K1's laid-out tiles
    assert const("WIDE_BN") == kb.K1_WIDE_BN == kb.search_tile(kb.FEED_STREAMED)
    assert re.search(r"struct Wide : Shape<WIDE_BN, 1, 1, Cfg<Search::ARGMIN>::BN>", src)
    # K1-kb's slabs end on chunk ends
    assert 128 % kb.GEMM_BK == 0


def test_cpu_search_never_lays_out_and_wrappers_take_w_laid():
    """On the CPU the wrappers run their plain versions and ignore
    ``w_laid``; ``PackedCodebook`` lays nothing out there."""
    x, w = _data(40, 30, 6, 9)
    for mode in ("packed", "split3"):
        cb = kb.PackedCodebook(w, mode)
        i, v = cb.argmin(x)
        assert cb._laid is None
        ops = cb.operands(x)
        fn = kb.bmu_split3 if mode == "split3" else kb.bmu_argmin
        i2, v2 = fn(*ops, w_laid=cb.laid() if mode == "split3" else cb.laid()[0])
        assert torch.equal(i, i2) and torch.equal(v, v2)
        assert cb._laid is not None
    # K2 and K1-kb: PackedCodebook's top2, kblock and margin routes lay
    # nothing out; the wrappers ignore w_laid
    for mode in ("packed", "bf16"):
        cb = kb.PackedCodebook(w, mode)
        top2 = cb.top2(x)
        i, v = cb.argmin(x, kblock=128)
        assert cb._laid is None
        ops = cb.operands(x)
        again = kb.bmu_top2(*ops, w_laid=cb.laid()[0])
        assert all(torch.equal(p, q) for p, q in zip(top2, again))
        i2, v2 = kb.bmu_argmin_kb(*ops, 128, w_laid=cb.laid()[0])
        assert torch.equal(i, i2) and torch.equal(v, v2)
    cb = kb.PackedCodebook(w, "margin")
    cb.argmin(x)
    assert cb._laid is None


@pytest.mark.parametrize("n,xy,d", SHAPES)
@pytest.mark.parametrize("part", ["packed", "bf16", "split2", "split3_hi", "split3_lo"])
@pytest.mark.parametrize("centered", [True, False])
def test_fused_sample_layout_is_the_packed_operand_laid_out(n, xy, d, part, centered):
    """lay_out_samples (the card's one-pass packing and layout) reads back
    as pack_samples / split3_samples of the centered samples, bit for bit;
    its K is the codebook's."""
    x, w = _data(n, xy, d, n + 3)
    mode = "split3" if part.startswith("split3") else part
    cb = kb.PackedCodebook(w, mode, center=centered)
    laid = kb.lay_out_samples(x, cb.center, part)
    ops = cb.operands(x)
    want = ops[part == "split3_lo"] if mode == "split3" else ops[0]
    assert torch.equal(_bits(_unlay(laid, n, want.shape[1], kb.GEMM_BM)), _bits(want))
    assert laid.shape == (-(-n // kb.GEMM_BM) * kb.GEMM_BM * want.shape[1],)
