"""The benchmark's counters against counts made by hand at one small shape."""
import pytest

from bench import yardstick


def test_sage_step_flops_by_hand():
    # batch 2, fanouts (3, 2), in 4, hidden 5, classes 3: levels 2, 6, 12
    # layer 0 (4 -> 5): levels 0, 1 as destinations, W_self and W_nbr
    #   rows (2 + 6) * 2 = 16; forward 2 * 16 * 4 * 5 = 640; weight grads
    #   only (its inputs are feature rows): x 2 = 1280
    # layer 1 (5 -> 5): level 0, rows 2 * 2 = 4; forward 2 * 4 * 5 * 5 =
    #   200; weight and input grads: x 3 = 600
    # head (5 -> 3) on 2 seeds: 2 * 2 * 5 * 3 = 60, x 3 = 180
    assert yardstick.step_matmul_flops("sage", 2, (3, 2), 4, 5, 3) == \
        1280 + 600 + 180


def test_gat_step_flops_by_hand():
    # layer 0: W_self on levels 0, 1 (2 + 6 rows), W_nbr on levels 1, 2
    #   (6 + 12 rows): 26 rows, forward 2 * 26 * 4 * 5 = 1040, x 2 = 2080
    # layer 1: W_self on level 0 (2), W_nbr on level 1 (6): 8 rows,
    #   forward 2 * 8 * 5 * 5 = 400, x 3 = 1200
    # head: 180 as above
    assert yardstick.step_matmul_flops("gat", 2, (3, 2), 4, 5, 3) == \
        2080 + 1200 + 180


def test_paper_sizes_match_their_orders_of_magnitude():
    sage = yardstick.step_matmul_flops("sage", 1024, (10, 5, 5), 1024, 128,
                                       19)
    gat = yardstick.step_matmul_flops("gat", 1024, (10, 5, 5), 1024, 128, 19)
    assert 60e9 < sage < 75e9 and 2.8 < gat / sage < 3.3


def test_kernel_bytes_by_hand():
    # 4 destinations x fanout 3 int32 indices = 48 B, 5 distinct rows of
    # 8 float32 = 160 B read, 4 means of 8 float32 = 128 B written
    assert yardstick.segment_mean_bytes(4, 3, 5, 8) == 48 + 160 + 128
    # 6 requests: 24 B of slots, 6 rows of 8 float32 read and written
    assert yardstick.tiered_gather_bytes(6, 8) == 24 + 2 * 192


def test_percentile_and_share_of_peak():
    vals = list(range(1, 102))          # 1 .. 101
    assert yardstick.percentile(vals, 90) == pytest.approx(91.0)
    assert yardstick.share_of_peak(67e12, 1.0, 67e12) == pytest.approx(100)
