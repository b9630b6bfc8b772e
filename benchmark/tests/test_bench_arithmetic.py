"""The metric arithmetic: a tail over every request, a rate over all the
work and all the time, the leaf gaps and the verdict."""

import numpy as np
import pytest

from harness import stats
from harness.compare import verdict, worst_leaf_gap


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 400, 1001])
def test_p95_over_every_request_equals_numpy(n):
    v = list(np.random.default_rng(n).exponential(size=n))
    assert stats.p95(v) == pytest.approx(float(np.percentile(v, 95)))


def test_p95_sees_the_tail_not_a_chunk_median():
    lat = [0.010] * 95 + [0.100] * 5
    # medians of chunks of 10 would read 10 ms; the tail is 100 ms
    assert stats.p95(lat) == pytest.approx(0.01 + 0.05 * 0.09)
    assert stats.p95([0.010] * 94 + [0.100] * 6) == pytest.approx(0.1)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(300 * 4, 30.0) == 40.0


def test_worst_leaf_gap_uses_median_floor_and_missing_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert worst_leaf_gap({"a": 1.01, "b": 2.0, "c": 0.0}, ref) == \
        pytest.approx(0.01)
    assert worst_leaf_gap({"a": 1.0, "b": 2.0}, ref) == 1.0
    assert worst_leaf_gap({"a": 0.0, "b": 0.0, "c": 0.0}, ref) == 1.0


def test_sixths_count_items_by_part_of_the_window():
    assert stats.sixths([0.5, 1.0, 5.9, 6.0, 30.0], 0.0, 30.0) == [2, 2, 0, 0, 0, 1]


def test_verdict_fails_nan_and_over_limit():
    assert verdict({"x": 0.1}, {"x": 0.2}) == (True, {"x": [0.1, 0.2]})
    assert not verdict({"x": 0.3}, {"x": 0.2})[0]
    assert not verdict({"x": float("nan")}, {"x": 0.2})[0]
    assert not verdict({}, {"x": 0.2})[0]
