"""Tails, whole-window means and busy time against hand counts."""

import numpy as np
import pytest

from harness import stats


def test_percentile_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 200):
        v = list(rng.random(n) * 100)
        for q in (0, 50, 95, 100):
            assert stats.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)))


def test_p95_by_hand():
    # 21 values 0..20: rank 0.95 * 20 = 19 exactly
    assert stats.percentile(list(range(21)), 95) == 19.0
    # 11 values: rank 9.5, halfway between 9 and 10
    assert stats.percentile(list(range(11)), 95) == 9.5


def test_window_mean_is_wall_over_completed():
    assert stats.window_mean_ms(30.0, 200) == 150.0
    with pytest.raises(ValueError):
        stats.window_mean_ms(30.0, 0)


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert stats.union_length([(3, 3), (4, 2)]) == 0
    assert stats.union_length([]) == 0


def test_gaps_and_idle_share():
    busy = [(1, 2), (1.5, 3), (6, 8)]
    assert stats.gaps(busy, 0, 10) == [(0, 1), (3, 6), (8, 10)]
    # busy 2 + 2 of 10: idle 0.6 (summing durations would say 0.5)
    assert stats.idle_share(busy, 0, 10) == pytest.approx(0.6)
    # intervals clipped to the window
    assert stats.idle_share([(-5, 5)], 0, 10) == pytest.approx(0.5)
