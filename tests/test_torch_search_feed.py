"""K1's and K2's feeds (``csrc/gemm_sm90.cu``): A streamed beside each
codebook chunk, pairs of row blocks that share each codebook chunk (a
cluster of two), or A held in registers; and the codebook tile each feed
searches (256 rows on the two deep feeds, 128 with A in registers). The
rule that picks a feed from the shape, the tile width that follows it, the
feed each launch site passes, and the ``paired``, ``registers``,
``wide`` and ``streamed`` counters that ``launch_counts()`` carries. The kernels
themselves run only on a card, where ``chip_smoke.py`` and
``tests/test_torch_card.py`` hold every feed to the same bits; here the C
entry is stubbed."""

import pytest
import torch

from xpysom_dask_tpu_torch.ops import kernels
from xpysom_dask_tpu_torch.ops.kernels import bmu as kb

# rows: 1, 2, 3 and 129 row blocks of GEMM_BM, and the edges of one
ROW_BLOCKS = {1: 1, 64: 1, 128: 1, 129: 2, 384: 3, 16384 + 64: 129}
WEBSOM = (1044 * 960, 3 * 500 + 3)  # websom-fit's codebook: 3.0 GB laid out


@pytest.mark.parametrize("n", list(ROW_BLOCKS))
@pytest.mark.parametrize("k", [18, 64, 93, 153, 195, 208, 256])
def test_a_in_registers_wherever_the_padded_depth_fits(n, k):
    assert kb.search_feed(n, k, 16384) == kb.FEED_REGISTERS
    assert kb.search_feed(n, k, WEBSOM[0]) == kb.FEED_REGISTERS


@pytest.mark.parametrize("n", list(ROW_BLOCKS))
def test_pairs_where_two_row_blocks_search_a_codebook_beyond_l2(n):
    xy, k = WEBSOM
    assert -(-n // kb.GEMM_BM) == ROW_BLOCKS[n]
    want = kb.FEED_PAIRS if ROW_BLOCKS[n] >= 2 else kb.FEED_STREAMED
    assert kb.search_feed(n, k, xy) == want


@pytest.mark.parametrize("xy,k", [(16384, 1503), (3000, 1503), (16384, 257), (16000, 1600)])
def test_a_streamed_where_a_deep_codebook_fits_l2(xy, k):
    assert -(-xy // kb.K1_BN) * kb.K1_BN * -(-k // 16) * 16 * 2 <= kb.L2_BYTES
    assert kb.search_feed(16384, k, xy) == kb.FEED_STREAMED


def test_the_l2_edge_and_the_register_depth():
    assert kb.REGISTER_K == 256 and kb.L2_BYTES == 50 * 2**20
    k16 = 1504
    rows = kb.L2_BYTES // (2 * k16) // kb.K1_BN * kb.K1_BN  # the most 128-row tiles in L2
    assert kb.search_feed(16384, k16, rows) == kb.FEED_STREAMED
    assert kb.search_feed(16384, k16, rows + 1) == kb.FEED_PAIRS
    assert kb.search_feed(16384, 257, 10**6) == kb.FEED_PAIRS  # 272 deep: past the registers


@pytest.mark.parametrize("feed,width", [(kb.FEED_STREAMED, 256), (kb.FEED_PAIRS, 256),
                                        (kb.FEED_REGISTERS, 128)])
def test_the_tile_is_wide_on_the_deep_feeds_only(feed, width):
    assert kb.search_tile(feed) == width
    assert kb.K1_WIDE_BN == 2 * kb.K1_BN  # two laid-out tiles side by side in a stage


@pytest.mark.parametrize("n", list(ROW_BLOCKS))
@pytest.mark.parametrize("k,xy", [(208, 16384), (256, WEBSOM[0]), (257, 300), (1503, 3000),
                                  (WEBSOM[1], WEBSOM[0]), (1552, 7830 * 128 + 128)])
def test_the_routed_tile_is_wide_past_the_register_depth(n, k, xy):
    deep = -(-k // 16) * 16 > kb.REGISTER_K
    assert (kb.search_tile(kb.search_feed(n, k, xy)) == kb.K1_WIDE_BN) == deep


@pytest.fixture
def stub_entry(monkeypatch):
    """``_gemm_sm90`` recording each call's entry and trailing ints, and
    every counter from 0 (restored afterwards)."""
    calls = []

    def entry(name, operands, n, k, xy, *ints, outs=2):
        calls.append((name, ints))
        return tuple(torch.zeros(n) for _ in range(outs))

    monkeypatch.setattr(kb, "_gemm_sm90", entry)
    for fn in kernels.KERNELS.values():
        monkeypatch.setattr(fn, "launches", 0)
    for name in kernels.FED:
        for feed in kernels.FEEDS:
            monkeypatch.setattr(kernels.KERNELS[name], feed, 0)
    return calls


@pytest.mark.parametrize("launch,entry,name", [
    (kb._launch_k1, "xps_gemm_argmin", "bmu_argmin"),
    (kb._launch_k2, "xps_gemm_top2", "bmu_top2"),
])
def test_launch_sites_pass_the_feed_and_count_it(stub_entry, launch, entry, name):
    a = torch.zeros(8, dtype=torch.bfloat16)
    shapes = [(16384, 195, 16384), (64, 195, 16384), (16448, *WEBSOM[::-1]), (64, *WEBSOM[::-1]),
              (16384, 1503, 3000)]
    for n, k, xy in shapes:
        launch(a, a, n, k, xy)
    assert stub_entry == [(entry, (kb.search_feed(n, k, xy),)) for n, k, xy in shapes]
    counts = kernels.launch_counts()
    assert counts[name] == len(shapes)
    assert counts[f"{name}.registers"] == 2
    assert counts[f"{name}.paired"] == 1  # 16448 rows of websom-fit's codebook, not 64
    assert counts[f"{name}.streamed"] == 2  # 64 rows of it, and a codebook within L2
    assert counts[f"{name}.wide"] == 3  # every launch past the register depth
    launch(a, a, 0, 195, 16384)  # no rows: no launch
    launch(a, a, 0, *WEBSOM[::-1])
    assert kernels.launch_counts()[name] == len(shapes)
    assert kernels.launch_counts()[f"{name}.wide"] == 3


@pytest.mark.parametrize("launch,name", [(kb._launch_k1, "bmu_argmin"),
                                         (kb._launch_k2, "bmu_top2")])
@pytest.mark.parametrize("n,k,xy,wide", [
    (16384, 208, 16384, 0),  # the seismic cells' chunk: A in registers
    (16384, 256, 10**6, 0),  # the register depth's edge
    (16384, 272, 300, 1),  # three laid-out tiles: the last wide tile has one
    (16384, 1504, 1044 * 960, 1),  # websom-fit's chunk, pairs
    (64, 1504, 1044 * 960, 1),  # one row block, streamed
    (16384, 1552, 16384, 1),  # packed D = 512, streamed
])
def test_each_launch_counts_its_wide_tiles(stub_entry, launch, name, n, k, xy, wide):
    a = torch.zeros(8, dtype=torch.bfloat16)
    launch(a, a, n, k, xy)
    counts = kernels.launch_counts()
    assert counts[name] == 1 and counts[f"{name}.wide"] == wide
    other = "bmu_top2" if name == "bmu_argmin" else "bmu_argmin"
    assert counts[f"{other}.wide"] == 0


def test_k3_and_k1_kb_keep_their_entries(stub_entry):
    a = torch.zeros(8, dtype=torch.bfloat16)
    w_sq = torch.zeros(16384)
    kb._launch_k3((a, a), (a, a), 16384, 64, 16384, w_sq)
    kb._launch_kb(a, a, 16384, 1552, 16384, 512)
    assert stub_entry == [("xps_gemm_split3", (True,)), ("xps_gemm_argmin_kb", (512,))]
    counts = kernels.launch_counts()
    assert counts["bmu_split3"] == counts["bmu_argmin_kb"] == 1
    assert not any(v for key, v in counts.items() if "." in key)


def test_launch_counts_carry_the_feeds_beside_each_kernels_launches(stub_entry):
    kb.bmu_argmin.launches, kb.bmu_argmin.paired, kb.bmu_argmin.registers = 5, 3, 1
    kb.bmu_argmin.wide, kb.bmu_argmin.streamed = 4, 1
    kb.bmu_top2.launches, kb.bmu_top2.registers = 2, 2
    counts = kernels.launch_counts()
    assert kernels.FEEDS == ("paired", "registers", "wide", "streamed")
    assert set(counts) == set(kernels.KERNELS) | {
        f"{n}.{f}" for n in kernels.FED for f in kernels.FEEDS}
    assert {k: v for k, v in counts.items() if v} == {
        "bmu_argmin": 5, "bmu_argmin.paired": 3, "bmu_argmin.registers": 1,
        "bmu_argmin.wide": 4, "bmu_argmin.streamed": 1, "bmu_top2": 2, "bmu_top2.registers": 2}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def _chip_smoke():
    """``chip_smoke.py`` (the card's smoke test; its byte counts and
    kernel names need no card) as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_deep_feeds_read_a_once_for_every_wide_tile():
    """``phase_feeds``' byte counts at websom-fit's chunk: 128 row blocks
    read their A tile once for each of 3,915 tiles of 256 units (half of
    the 7,830 laid-out tiles), beside the whole codebook a block (pairs:
    once a pair from L2)."""
    cs = _chip_smoke()
    n, xy, d = cs.WEBSOM_CHUNK
    k16, rb = 1504, 128
    a = rb * 128 * k16 * 2 * 3915
    b = 7830 * 128 * k16 * 2
    assert a == 192_943_226_880
    assert cs._feed_bytes(n, xy, 3 * d + 3, kb.FEED_STREAMED) == (a + rb * b, a + rb * b)
    assert cs._feed_bytes(n, xy, 3 * d + 3, kb.FEED_PAIRS) == (a + rb * b, a + rb // 2 * b)
    # A in registers: each row block's A once
    assert cs._feed_bytes(16384, 16384, 195, kb.FEED_REGISTERS)[0] == (
        128 * 128 * 208 * 2 + 128 * 128 * 128 * 208 * 2)


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_116gemm_sm90_kernelILN8xps_gemm6SearchE0ELi2ELi0ELi4ELb1EEEvPK13__nv_bfloat16",
     "gemm_sm90_kernel <K1 ARGMIN> pair wide"),
    ("_ZN12_GLOBAL__N_116gemm_sm90_kernelILN8xps_gemm6SearchE2ELi1ELi0ELi4ELb1EEEvPK13__nv_bfloat16",
     "gemm_sm90_kernel <K2 TOP2> wide"),
    ("_ZN12_GLOBAL__N_116gemm_sm90_kernelILN8xps_gemm6SearchE0ELi1ELi3ELi8ELb0EEEvPK13__nv_bfloat16",
     "gemm_sm90_kernel <K1 ARGMIN> A in registers x3"),
    ("_ZN12_GLOBAL__N_116gemm_sm90_kernelILN8xps_gemm6SearchE3ELi1ELi0ELi4ELb0EEEvPK13__nv_bfloat16",
     "gemm_sm90_kernel <K1-kb KBLOCKED>"),
])
def test_ptxas_names_the_wide_instances(mangled, label):
    assert _chip_smoke()._kernel_name(mangled) == label
