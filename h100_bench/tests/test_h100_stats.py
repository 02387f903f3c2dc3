"""The rate and percentile arithmetic."""

import pytest

from h100_bench.stats import percentile, rate


def test_rate_counts_whole_requests_to_the_last_completion():
    assert rate([2.0, 3.0, 5.0], 10.0, [11.0, 12.0, 15.0]) == pytest.approx(10.0 / 5.0)
    with pytest.raises(ValueError):
        rate([], 0.0, [])


@pytest.mark.parametrize('q, want', [(50, 50), (95, 95), (100, 100), (1, 1)])
def test_percentile_is_nearest_rank_over_all_samples(q, want):
    samples = list(range(100, 0, -1))  # 1 .. 100, unordered
    assert percentile(samples, q) == want


def test_percentile_of_few_samples_is_their_maximum():
    assert percentile([3.0, 1.0, 2.0], 95) == 3.0

