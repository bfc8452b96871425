"""The least-work counts against a hand count at a tiny shape, and the
least time they give."""

import pytest

from harness import peaks
from work import euclidean, manhattan

N, X, Y, D = 3, 2, 5, 4  # 3 rows on a 2 x 5 map of 4 features


def test_euclidean_search_is_one_gemm():
    # 3 rows x 10 units x 4 features, a multiply and an add each
    assert euclidean.search(N, X * Y, D) == {"tensor_flops": 240.0, "bytes": 4.0 * (12 + 40)}


def test_manhattan_search_is_two_fp32_instructions_a_term():
    assert manhattan.search(N, X * Y, D) == {"fp32_instr": 240.0, "bytes": 4.0 * (12 + 40)}


def test_stats_reads_the_rows_and_writes_the_sums_once():
    # [x | 1] read once (12 floats, the 1 implicit), [S | cnt] written once (10 x 5)
    assert euclidean.stats(N, X * Y, D) == {"bytes": 4.0 * (12 + 50)}


def test_update_is_the_separable_gaussian():
    # Ax over x: 2*X*X*Y, Ay over y: 2*X*Y*Y multiply-adds a column, D + 1 columns
    w = euclidean.update(X, Y, D)
    assert w["tensor_flops"] == 2.0 * (2 * 2 * 5 + 2 * 5 * 5) * 5
    assert w["bytes"] == 4.0 * (10 * 5 + 2 * 10 * 4)


@pytest.mark.parametrize("module", [euclidean, manhattan])
def test_epoch_is_the_sum_of_its_stages(module):
    e = module.epoch(N, X, Y, D)
    parts = [module.search(N, X * Y, D), module.stats(N, X * Y, D), module.update(X, Y, D)]
    for key in e:
        assert e[key] == sum(p.get(key, 0.0) for p in parts)


def test_flagship_search_least_time():
    # 2 * 2^22 * 16384 * 64 flops at 989 TFLOP/s
    t = euclidean.search(1 << 22, 16384, 64)["tensor_flops"] / peaks.BF16_FLOPS
    assert t == pytest.approx(8.895e-3, rel=1e-3)
    m = manhattan.search(1 << 20, 16384, 64)["fp32_instr"] / peaks.FP32_INSTR
    assert m == pytest.approx(65.63e-3, rel=1e-3)
