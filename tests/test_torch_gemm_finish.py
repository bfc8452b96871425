"""K2's top-2 finish (``csrc/gemm_sm90.cu``, variant TOP2) emulated on the
CPU: which thread owns which rows and columns of a tile, its walk over
its columns in increasing order, the merge across the quad of lanes that
share a row (``__shfl_xor_sync`` offsets 1 and 2), and the carry from
tile to tile. The model runs on integer-valued f32 distance matrices
that hold the ties the finish must order: a duplicate minimum in one
thread's own columns (0 and 8), in another quad lane (0 and 2) and
across tiles (0 and 128, 127 and 128), a runner-up that ties the
winner's value at a lower index than a third, and xy = 129, whose last
tile has one column. It must equal ``bmu_top2_plain`` in all four
outputs, and its first place the K1 finish's. The same finish over
256-column tiles (K1 and K2 on the deep feeds) gives the 128-column
finish's outputs bit for bit, with ties across the 128-column seam of a
wide tile and across wide tiles, and an odd count of 128-column tiles."""

import numpy as np
import pytest
import torch

from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

INT_MAX = 2**31 - 1


def _lex_less(a, b):
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_top2(mine, other):
    """csrc/gemm_sm90.cu merge_top2: the sorted pair ``other`` into the
    sorted pair ``mine``; both are [(value, index), (value, index)]."""
    (v, i), (v2, i2) = mine
    (ov, oi), (ov2, oi2) = other
    if _lex_less((ov, oi), (v, i)):
        second = (v, i) if _lex_less((v, i), (ov2, oi2)) else (ov2, oi2)
        return [(ov, oi), second]
    if _lex_less((ov, oi), (v2, i2)):
        return [(v, i), (ov, oi)]
    return mine


def _thread_walk(drow, col0, q, xy, top2, bn=kb.K1_BN):
    """One thread's walk over its columns col0 + j·8 + 2q + e of one row
    (a tile of ``bn`` columns), in increasing order, with a strict '<' (f32
    compares); (inf, INT_MAX) where no column is below +inf."""
    inf = np.float32(np.inf)
    places = [[inf, -1], [inf, -1]]
    for j in range(bn // 8):
        for e in range(2):
            col = col0 + j * 8 + 2 * q + e
            if col >= xy:
                continue
            v = drow[col]
            if v < places[0][0]:
                places = [[v, col], places[0]]
            elif top2 and v < places[1][0]:
                places[1] = [v, col]
    return [(v, INT_MAX if c < 0 else c) for v, c in places]


def _emulated_finish(d, xy, top2, bn=kb.K1_BN):
    """The finish of K2 (``top2``) or K1 over the f32 distances ``d`` (N,
    XY): per 128-row block, warpgroup, warp and accumulator row g, the
    thread of quad lane q holds rows g and g + 8 of its warp's 16 and, in
    every ``bn``-column tile, the columns j·8 + 2q + e. Returns (idx, val,
    idx2, val2) as the kernel writes them (K1: idx2, val2 unused)."""
    n = d.shape[0]
    bm = kb.GEMM_BM
    out = [np.full(n, -7, np.int32), np.full(n, np.nan, np.float32),
           np.full(n, -7, np.int32), np.full(n, np.nan, np.float32)]
    seen = np.zeros(n, int)
    inf = np.float32(np.inf)
    for blk in range(-(-n // bm)):
        for wg in range(2):
            for warp in range(4):
                for g in range(8):
                    for h in range(2):
                        row = blk * bm + wg * 64 + warp * 16 + g + 8 * h
                        if row >= n:
                            continue  # the layout's zero rows: searched, never written
                        seen[row] += 1
                        best = [(inf, INT_MAX if top2 else 0), (inf, INT_MAX)]
                        for col0 in range(0, xy, bn):
                            lanes = [_thread_walk(d[row], col0, q, xy, top2, bn)
                                     for q in range(4)]
                            for o in (1, 2):
                                if top2:
                                    lanes = [_merge_top2(lanes[q], lanes[q ^ o]) for q in range(4)]
                                else:
                                    lanes = [[min(lanes[q][0], lanes[q ^ o][0],
                                                  key=lambda p: (p[0], p[1]))] * 2
                                             for q in range(4)]
                            assert all(lane == lanes[0] for lane in lanes)  # the quad agrees
                            if top2:
                                best = _merge_top2(best, lanes[0])
                            elif lanes[0][0][0] < best[0][0]:  # strict: earlier tiles keep ties
                                best = [lanes[0][0], best[1]]
                        out[0][row], out[1][row] = best[0][1], best[0][0]
                        out[2][row], out[3][row] = best[1][1], best[1][0]
    assert (seen == 1).all()  # every row is owned by one thread
    return out


def _fixture(xy, n, seed, extra=()):
    """Integer-valued f32 distances (N, XY), each row one of a set of
    scenarios (``extra``: more, as ``{"c<column>": value}``), and one-hot
    bf16 operands ``(a, w_aug)`` whose product is exactly that matrix (one
    product per sum, every value exact in bf16)."""
    rng = np.random.RandomState(seed)
    base = (40 + (np.arange(xy) * 7) % 50).astype(np.float32)  # repeats every 50 columns
    rows = []

    def scenario(**at):
        r = base.copy()
        for col, v in at.items():
            r[int(col[1:]) % xy] = v
        rows.append(r)

    scenario(c0=1, c8=1)  # a duplicate minimum in one thread's own columns
    scenario(c0=1, c2=1)  # in another quad lane
    scenario(c0=1, c128=1)  # across tiles
    scenario(c127=1, c128=1)  # the last column of a tile and the first of the next
    scenario(c5=1, c64=1, c128=1)  # the runner-up ties the winner below a third
    scenario(c50=1, c100=2, c20=2)  # a duplicated runner-up value, the lower index first
    scenario(c0=1, c1=1)  # both columns of one lane's pair
    scenario(c1=1, c3=2, c6=2)  # a runner-up tie across quad lanes
    for at in extra:
        scenario(**at)
    rows.append(np.where(np.arange(xy) == xy - 1, 0, base).astype(np.float32))  # the last column wins
    rows.append(np.where(np.arange(xy) == xy - 1, 1, np.where(np.arange(xy) == 10, 0, base))
                .astype(np.float32))  # the last column is the runner-up
    rows.append(np.full(xy, 7, np.float32))  # every column ties
    while len(rows) < 32:  # dense ties of small values
        rows.append(rng.randint(0, 4, size=xy).astype(np.float32))
    table = np.stack(rows)
    pick = rng.permutation(np.arange(n) % len(table))
    a = np.zeros((n, len(table)), np.float32)
    a[np.arange(n), pick] = 1
    w_aug = np.zeros((len(table), -(-xy // 8) * 8), np.float32)
    w_aug[:, :xy] = table
    return (table[pick], torch.from_numpy(a).to(torch.bfloat16),
            torch.from_numpy(w_aug).to(torch.bfloat16))


@pytest.mark.parametrize("n", [203, 300])
@pytest.mark.parametrize("xy", [129, 200, 259])
def test_emulated_top2_finish_equals_the_plain_version(xy, n):
    d, a, w_aug = _fixture(xy, n, xy + n)
    # the plain version's distances are the fixture's, exactly
    assert np.array_equal(kb._distances_plain(a, w_aug, xy).numpy(), d)
    got = _emulated_finish(d, xy, top2=True)
    want = [t.numpy() for t in kb.bmu_top2_plain(a, w_aug, xy)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] == got[3]).sum() >= n // 4  # the fixture's ties reach the runner-up
    # the first place is K1's finish, and K1's plain version
    k1 = _emulated_finish(d, xy, top2=False)
    np.testing.assert_array_equal(got[0], k1[0])
    np.testing.assert_array_equal(got[1].view(np.int32), k1[1].view(np.int32))
    i1, v1 = kb.bmu_argmin_plain(a, w_aug, xy)
    np.testing.assert_array_equal(got[0], i1.numpy())


@pytest.mark.parametrize("xy", [129, 259])
def test_emulated_top2_finish_is_the_stable_argsort(xy):
    """On f32 values that are not integers, with planted duplicates, the
    finish gives the first two columns of a stable argsort of each row."""
    rng = np.random.RandomState(xy)
    d = rng.randn(150, xy).astype(np.float32)
    d[::3, 128 % xy] = d[::3, 0]
    d[1::3, 2] = d[1::3].min(1)
    got = _emulated_finish(d, xy, top2=True)
    order = np.argsort(d, axis=1, kind="stable")[:, :2]
    np.testing.assert_array_equal(got[0], order[:, 0])
    np.testing.assert_array_equal(got[2], order[:, 1])
    np.testing.assert_array_equal(got[1], d[np.arange(150), order[:, 0]])
    np.testing.assert_array_equal(got[3], d[np.arange(150), order[:, 1]])


@pytest.mark.parametrize("n", [203, 300])
@pytest.mark.parametrize("xy", [129, 259, 300, 513])
def test_emulated_wide_finish_equals_the_128_column_finish(xy, n):
    """K1's and K2's finish over 256-column tiles (two laid-out tiles a
    stage on the deep feeds) gives the 128-column finish's four outputs
    bit for bit, and the plain version's: ties on either side of the
    128-column seam inside a wide tile (127, 128), across wide tiles (255,
    256; 0, 256; 300, 600) and, at xy = 300 and 513, a last wide tile
    with one laid-out tile."""
    seams = [dict(c255=1, c256=1), dict(c0=1, c256=1), dict(c300=1, c600=1),
             dict(c127=2, c128=1, c256=1), dict(c200=3, c384=3, c512=3)]
    d, a, w_aug = _fixture(xy, n, 3 * xy + n, extra=seams)
    assert np.array_equal(kb._distances_plain(a, w_aug, xy).numpy(), d)
    want = [t.numpy() for t in kb.bmu_top2_plain(a, w_aug, xy)]
    for top2 in (True, False):
        wide = _emulated_finish(d, xy, top2, bn=kb.K1_WIDE_BN)
        narrow = _emulated_finish(d, xy, top2)
        for w, t in zip(wide, narrow):
            np.testing.assert_array_equal(w.view(np.int32), t.view(np.int32))
        for w, p in zip(wide if top2 else wide[:2], want):
            np.testing.assert_array_equal(w, p)
