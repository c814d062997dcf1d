"""The frozen cost model on hand-worked shapes."""

import pytest

from benchmark import costmodel


def test_peaks_are_the_data_sheet():
    assert costmodel.HBM_BYTES_PER_S == 3.35e12
    assert costmodel.FP32_FLOPS_PER_S == 67e12
    assert costmodel.POWER_LIMIT_W == 700.0


def test_score_topk_bytes_hand_worked():
    # 2 docs, 5 head slots, V 8, k 3:
    # heads 5 x (4 id + 4 count) = 40; lengths 2 x 4 = 8; idf 8 x 4 = 32;
    # out 2 x 3 x (4 + 4) = 48
    assert costmodel.score_topk_bytes(2, 5, 8, 3) == 40 + 8 + 32 + 48


def test_tile_scores_cost_hand_worked():
    # 10 head slots, 4 queries of 2 terms with 6 postings each, k 2:
    # face 10 x 8 = 80; queries 4 x 2 x 8 = 64; out 4 x 2 x 8 = 64
    cost = costmodel.tile_scores_cost(10, 4, 2, 6, 2)
    assert cost["bytes"] == 80 + 64 + 64
    assert cost["flops"] == 2 * 4 * 6


def test_least_seconds_is_the_binding_roof():
    assert costmodel.least_seconds(3.35e12) == pytest.approx(1.0)
    assert costmodel.least_seconds(3.35e9, 67e12) == pytest.approx(1.0)
