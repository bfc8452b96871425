"""The register-tiled engine of the elementwise searches (K5–K7) and K8's
matrix (``csrc/tile_argmin.cuh``) on the CPU: the layout pre-pass's plain
version (``lay_out_f32_plain``, which ``lay_out_f32`` runs on CPU tensors)
against an independent element-wise index map and against the kernel's own
index arithmetic (``layout_f32_kernel``); the codebook segments of
``tile_plan``; and the kernel's walk emulated in numpy f32 from the laid
arrays — a block's samples resident or in d-slabs, the codebook chunks
stage by stage, each thread's 8 x 8 register tile with its rows and columns,
the per-thread running minimum (fminf, then the first column holding it),
the lexicographic butterfly over the 16 lanes of a row, one (value, index)
per segment and the strict-'<' merge in segment order — held bit for bit
against ``first_argmin(sum_over_d(...))`` (the plain versions) on random,
integer-tie, ragged and d-slab fixtures, and K8's store epilogue against
``manhattan_distance_plain``."""

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch.ops.distances import sum_over_d
from xpysom_dask_tpu_torch.ops.kernels import elementwise as ke
from xpysom_dask_tpu_torch.ops.kernels import manhattan as km
from xpysom_dask_tpu_torch.ops.kernels import tile as kt

BM, BN, KC = kt.EW_BM, kt.EW_BN, kt.EW_KC
# csrc/tile_argmin.cuh: the samples stay resident up to this padded depth
RESIDENT_D = 256
TM = TN = 8
F32 = np.float32


def _offset(r, k, trows, d):
    """Element offset of (row r, depth k) in the laid array: tile, chunk,
    depth in the chunk, row in the tile."""
    d32 = -(-d // KC) * KC
    return (r // trows) * trows * d32 + (k // KC) * KC * trows + (k % KC) * trows + r % trows


def _kernel_layout(t, trows):
    """layout_f32_kernel's index arithmetic: block b = tile * nk + chunk
    reads 4-vector e of its chunk at row e // 8, depths 4 (e % 8) .. + 3
    from the row-major source (zero past rows and d) and writes output
    4-vector e from depth e // (trows / 4), rows 4 (e % (trows / 4)) .. + 3."""
    rows, d = t.shape
    nk = -(-d // KC)
    out = np.full(-(-rows // trows) * nk * trows * KC, np.nan, F32)
    e = np.arange(trows * KC // 4)
    for b in range(-(-rows // trows) * nk):
        r0, k0 = b // nk * trows, b % nk * KC
        tile = np.full((KC, trows), np.nan, F32)
        r, k = e // (KC // 4), 4 * (e % (KC // 4))
        for q in range(4):
            ok = (r0 + r < rows) & (k0 + k + q < d)
            tile[k + q, r] = np.where(ok, t[np.minimum(r0 + r, rows - 1),
                                            np.minimum(k0 + k + q, d - 1)], 0)
        k, r = e // (trows // 4), 4 * (e % (trows // 4))
        for q in range(4):
            out[b * trows * KC + 4 * e + q] = tile[k, r + q]
    return out


@pytest.mark.parametrize("rows,d,trows", [(1, 1, 64), (64, 32, 64), (130, 5, 64), (300, 70, 128),
                                          (129, 300, 128), (7, 33, 128)])
def test_layout_is_the_index_map_and_the_kernels_arithmetic(rows, d, trows):
    rng = np.random.RandomState(rows + d)
    t = rng.rand(rows, d).astype(F32) + 1  # no zeros: padding shows
    flat = kt.lay_out_f32(torch.from_numpy(t), trows)
    padded, d32 = -(-rows // trows) * trows, -(-d // KC) * KC
    assert flat.shape == (padded * d32,) and flat.dtype == torch.float32
    flat = flat.numpy()
    r, k = np.meshgrid(np.arange(padded), np.arange(d32), indexing="ij")
    off = _offset(r, k, trows, d).reshape(-1)
    np.testing.assert_array_equal(np.sort(off), np.arange(padded * d32))  # a bijection
    np.testing.assert_array_equal(flat[_offset(*np.meshgrid(np.arange(rows), np.arange(d),
                                                            indexing="ij"), trows, d)], t)
    assert np.count_nonzero(flat) == rows * d  # zero past the rows and past d
    np.testing.assert_array_equal(_kernel_layout(t, trows), flat)


@pytest.mark.parametrize("n,xy,sms", [(16384, 16384, 132), (1024, 16384, 132), (5, 300, 132),
                                      (1000, 50, 132), (300, 600, 2), (1, 10**6, 132),
                                      (16384, 100, 132), (0, 130, 132)])
def test_tile_plan_cuts_the_codebook_into_segments(n, xy, sms):
    tps, segs = kt.tile_plan(n, xy, sms)
    nt, rb = -(-xy // BN), -(-n // BM)
    assert tps >= 1 and 1 <= segs <= 65535
    # every tile in exactly one segment, none empty
    assert (segs - 1) * tps < nt <= segs * tps
    if rb >= 2 * sms:
        assert segs == 1
    elif rb:
        # at least a block per SM where the tiles allow it, and not many
        # more than two per SM
        assert min(rb * nt, sms) <= rb * segs <= 4 * sms + rb
    if (n, xy) == (16384, 16384):
        assert segs == 1  # the flagship chunk: 256 row blocks already
    if (n, xy) == (1024, 16384):
        assert (tps, segs) == (8, 16)  # activate's chunk: 256 blocks


def _row_of(i, ty):
    return (i >> 2) * 32 + 4 * ty + (i & 3)


def _col_of(j, tx):
    return (j >> 2) * 64 + 4 * tx + (j & 3)


# the thread's rows and columns: R[ty, i], C[tx, j]
R = np.array([[_row_of(i, ty) for i in range(TM)] for ty in range(BM // TM)])
C = np.array([[_col_of(j, tx) for j in range(TN)] for tx in range(BN // TN)])


def _lex_less(va, ia, vb, ib):
    return (va < vb) | ((va == vb) & (ia < ib))


def _block_walk(xb, wl, resident, nk, d, xy, tiles, term, reps):
    """One block of tile_kernel: the search over ``tiles`` for its BM rows;
    returns (value, index) per row of the block."""
    best = np.full((8, 16, TM), np.inf, F32)  # [ty, tx, i]
    besti = np.zeros((8, 16, TM), np.int64)
    xres = xb.copy() if resident else None  # the one bulk copy at block start
    for tile in tiles:
        acc = np.zeros((BM, BN), F32)
        for c in range(nk):
            # the stage: the codebook chunk (and the samples chunk in d-slabs)
            ws = wl[(tile * nk + c) * BN * KC:(tile * nk + c + 1) * BN * KC].reshape(KC, BN)
            xs = (xres[c * KC * BM:(c + 1) * KC * BM] if resident
                  else xb[c * BM * KC:(c + 1) * BM * KC]).reshape(KC, BM)
            for k in range(min(KC, d - c * KC)):  # padded depth never summed
                t = np.abs(xs[k][:, None] - ws[k][None, :])
                tp = term(t)
                for _ in range(reps):
                    tp = tp * t
                acc = acc + tp
        lim = xy - tile * BN
        # each thread's 8 x 8 tile: v[ty, tx, i, j]
        v = acc[R[:, None, :, None], C[None, :, None, :]]
        live = np.broadcast_to(C[None, :, None, :] < lim, v.shape)
        m = np.where(live, v, np.inf).min(-1)  # fminf over the live columns
        new = m < best
        first = np.argmax((v == m[..., None]) & live, axis=-1)
        best = np.where(new, m, best)
        besti = np.where(new, tile * BN + C[np.arange(16)[None, :, None], first], besti)
    # the lexicographic butterfly over the 16 lanes of a row group
    for off in (1, 2, 4, 8):
        partner = np.arange(16) ^ off
        ov, oi = best[:, partner], besti[:, partner]
        take = _lex_less(ov, oi, best, besti)
        best, besti = np.where(take, ov, best), np.where(take, oi, besti)
    val = np.empty(BM, F32)
    idx = np.empty(BM, np.int64)
    val[R] = best[:, 0]
    idx[R] = besti[:, 0]
    return val, idx


def _emulate_search(x, w, term, reps, sms):
    """tile_kernel's search and merge_kernel on the laid operands."""
    n, d = x.shape
    xy = w.shape[0]
    nk = -(-d // KC)
    d32 = nk * KC
    xl = kt.lay_out_f32_plain(torch.from_numpy(x), BM).numpy()
    wl = kt.lay_out_f32_plain(torch.from_numpy(w), BN).numpy()
    tps, segs = kt.tile_plan(n, xy, sms)
    nt = -(-xy // BN)
    pval = np.empty((segs, n), F32)
    pidx = np.empty((segs, n), np.int64)
    for s in range(segs):
        for rb in range(-(-n // BM)):
            xb = xl[rb * BM * d32:(rb + 1) * BM * d32]
            v, i = _block_walk(xb, wl, d32 <= RESIDENT_D, nk, d, xy,
                               range(s * tps, min(nt, (s + 1) * tps)), term, reps)
            rows = min(BM, n - rb * BM)
            pval[s, rb * BM:rb * BM + rows] = v[:rows]
            pidx[s, rb * BM:rb * BM + rows] = i[:rows]
    val, idx = pval[0].copy(), pidx[0].copy()
    for s in range(1, segs):  # strict '<' in segment order
        take = pval[s] < val
        val, idx = np.where(take, pval[s], val), np.where(take, pidx[s], idx)
    return idx, val, segs


_TERMS = {  # name: (emulated base, reps, plain version)
    "K5": (lambda t: t, 0, ke.bmu_manhattan_plain),
    "K6 p=3": (lambda t: t, 2, lambda x, w: ke.bmu_norm_p_odd_plain(x, w, 3)),
    "K6 p=5": (lambda t: t, 4, lambda x, w: ke.bmu_norm_p_odd_plain(x, w, 5)),
    # torch's CPU sqrt, as the plain version's (not numpy's: the two differ
    # in the last bit on some values)
    "K7 p=1.5": (lambda t: torch.sqrt(torch.from_numpy(t)).numpy(), 1,
                 lambda x, w: ke.bmu_norm_p_frac_plain(x, w, 1.5)),
}


def _fixture(kind, rng):
    if kind == "random":
        return rng.rand(150, 9).astype(F32), rng.rand(400, 9).astype(F32)
    if kind == "integer ties":  # exact ties within threads, lanes, tiles, segments
        return (rng.randint(0, 3, (200, 4)).astype(F32),
                rng.randint(0, 3, (700, 4)).astype(F32))
    if kind == "duplicate rows":  # a tie at 0 and above 0 across segments
        w = rng.rand(600, 6).astype(F32)
        w[[130, 520]] = w[3]
        w[[300, 599]] = w[129]
        x = np.vstack([w[[3, 129]], w[[3, 129]] + F32(1e-3), rng.rand(60, 6).astype(F32)])
        return x, w
    if kind == "n below a block":
        return rng.rand(5, 7).astype(F32), rng.rand(300, 7).astype(F32)
    if kind == "xy below a tile":
        return rng.rand(70, 1).astype(F32), rng.rand(50, 1).astype(F32)
    if kind == "ragged chunk":
        return rng.rand(130, 33).astype(F32), (rng.rand(129, 33) * 2 - 1).astype(F32)
    if kind == "d-slabs":  # padded depth 288 > RESIDENT_D: slabs beside the codebook
        return rng.rand(70, 260).astype(F32), rng.rand(260, 260).astype(F32)
    raise ValueError(kind)


# every term on every fixture but the slow d-slab one, which K5 carries
# (the walk does not depend on the term)
_KINDS = ["random", "integer ties", "duplicate rows", "n below a block", "xy below a tile",
          "ragged chunk"]
_CASES = [(name, kind) for name in _TERMS for kind in _KINDS] + [("K5", "d-slabs")]


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("name,kind", _CASES)
def test_emulated_walk_equals_the_plain_version_bit_for_bit(name, kind, sms):
    x, w = _fixture(kind, np.random.RandomState(len(kind) + sms))
    base, reps, plain = _TERMS[name]
    idx, val, segs = _emulate_search(x, w, base, reps, sms)
    i_p, v_p = plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(idx, i_p.numpy())
    np.testing.assert_array_equal(val.view(np.int32), v_p.numpy().view(np.int32))
    # the CPU wrapper is the plain version
    fn = {"K5": ke.bmu_manhattan}.get(name)
    if fn is not None:
        i_w, v_w = fn(torch.from_numpy(x), torch.from_numpy(w))
        assert torch.equal(i_w, i_p) and torch.equal(v_w.view(torch.int32), v_p.view(torch.int32))
    if kind == "duplicate rows":
        assert idx[:4].tolist() == [3, 129, 3, 129] and not val[:2].any()
    if sms == 132 and w.shape[0] > BN:
        assert segs > 1  # the merge across segments ran


def test_integer_tie_fixture_has_ties_across_segments():
    """The integer fixture's winners are ties: another column, in a later
    segment, holds the same minimum."""
    x, w = _fixture("integer ties", np.random.RandomState(len("integer ties") + 132))
    d = sum_over_d(torch.from_numpy(x), torch.from_numpy(w), lambda t: t).numpy()
    tps, segs = kt.tile_plan(x.shape[0], w.shape[0], 132)
    seg_of = np.arange(w.shape[0]) // (tps * BN)
    first = d.argmin(1)
    later = (d == d.min(1, keepdims=True)) & (seg_of[None, :] > seg_of[first][:, None])
    assert segs > 1 and later.any(1).mean() > 0.5


@pytest.mark.parametrize("kind", ["random", "ragged chunk", "xy below a tile", "d-slabs"])
def test_emulated_store_equals_k8_plain_bit_for_bit(kind):
    """K8's store epilogue: each thread's 8 x 8 sums at its rows and
    columns of the (n, xy) matrix, columns >= xy and rows >= n unwritten."""
    x, w = _fixture(kind, np.random.RandomState(3))
    n, d = x.shape
    xy = w.shape[0]
    nk, d32 = -(-d // KC), -(-d // KC) * KC
    xl = kt.lay_out_f32_plain(torch.from_numpy(x), BM).numpy()
    wl = kt.lay_out_f32_plain(torch.from_numpy(w), BN).numpy()
    out = np.full((n, xy), np.nan, F32)
    for rb in range(-(-n // BM)):
        xb = xl[rb * BM * d32:(rb + 1) * BM * d32]
        for tile in range(-(-xy // BN)):
            acc = np.zeros((BM, BN), F32)
            for c in range(nk):
                ws = wl[(tile * nk + c) * BN * KC:(tile * nk + c + 1) * BN * KC].reshape(KC, BN)
                xs = xb[c * BM * KC:(c + 1) * BM * KC].reshape(KC, BM)
                for k in range(min(KC, d - c * KC)):
                    acc = acc + np.abs(xs[k][:, None] - ws[k][None, :])
            rows = rb * BM + R.reshape(-1)
            cols = tile * BN + C.reshape(-1)
            ok_r, ok_c = rows < n, cols < xy
            out[np.ix_(rows[ok_r], cols[ok_c])] = acc[np.ix_(R.reshape(-1)[ok_r],
                                                             C.reshape(-1)[ok_c])]
    want = km.manhattan_distance_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))
    got = km.manhattan_distance(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got.view(torch.int32), torch.from_numpy(want).view(torch.int32))


def test_codebook_is_laid_out_once_and_cpu_routes_stay_plain():
    rng = np.random.RandomState(8)
    w = torch.from_numpy(rng.rand(300, 7).astype(F32))
    x = torch.from_numpy(rng.rand(40, 7).astype(F32))
    cb = ke.ElementwiseCodebook(w, "manhattan")
    laid = cb.laid()
    assert cb.laid() is laid
    assert torch.equal(laid, kt.lay_out_f32_plain(w, BN))
    i, v = cb.argmin(x)
    i_p, v_p = ke.bmu_manhattan_plain(x, w)
    assert torch.equal(i, i_p) and torch.equal(v.view(torch.int32), v_p.view(torch.int32))
    with pytest.raises(TypeError, match="float32"):
        kt.lay_out_f32(w.double(), BN)
