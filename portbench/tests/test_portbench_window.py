"""The window's arithmetic: rates over whole units, the spread, the check
for lost trace records, the device's busy union and its gaps."""
import statistics

import pytest

import pb_small  # noqa: F401  (puts the benchmark on the path)
from harness import profiling, stats


def test_rate_divides_all_work_by_time_to_last_end():
    assert stats.rate(4, 100.0, 10.0, 12.0) == pytest.approx(200.0)
    # a stall inside the window lowers the rate
    assert stats.rate(4, 100.0, 10.0, 14.0) < stats.rate(4, 100.0, 10.0,
                                                         12.0)
    with pytest.raises(ValueError):
        stats.rate(0, 1.0, 0.0, 1.0)


def test_whole_counts_every_kernel_in_whole_repeats():
    k = [("a", 0.0, 1.0)] * 6 + [("b", 0.0, 1.0)] * 3
    assert profiling.whole(dict(kernels=k), 3)
    # one record lost
    assert not profiling.whole(dict(kernels=k[1:]), 3)
    assert not profiling.whole(dict(kernels=[]), 1)


def test_spread_is_quartile_distance_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps_clip_to_the_window():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert stats.union_seconds(iv, 1.0, 10.0) == pytest.approx(
        2.0 + 1.0 + 1.0)
    assert stats.gaps(iv, 1.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
