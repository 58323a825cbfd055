"""The arithmetic of the end-to-end metrics, worked by hand."""

from __future__ import annotations

import pytest

from wbbench.lib import stats
from wbbench.lib.loop import Unit


def test_window_rate_counts_whole_exports_over_the_window():
    # three 180 s exports: 0.0-0.2, 0.25-0.45, 0.5-0.8 -> 540 s of audio over 0.8 s
    units = [Unit(0, 0.0, 0.2, 180.0), Unit(1, 0.25, 0.45, 180.0), Unit(2, 0.5, 0.8, 180.0)]
    assert stats.window_rate(units) == pytest.approx(540.0 / 0.8)


def test_window_rate_needs_a_unit():
    with pytest.raises(ValueError):
        stats.window_rate([])


@pytest.mark.parametrize("p, want", [(95, 95), (99, 99), (50, 50), (100, 100), (1, 1)])
def test_percentile_is_the_nearest_rank(p, want):
    assert stats.percentile(list(range(100, 0, -1)), p) == want


def test_percentile_of_few_values():
    # 20 values: the 95th percentile is the 19th smallest, the 99th the 20th
    v = [float(i) for i in range(1, 21)]
    assert stats.percentile(v, 95) == 19.0
    assert stats.percentile(v, 99) == 20.0


def test_median_even_and_odd():
    assert stats.median([3.0, 1.0, 2.0]) == 2.0
    assert stats.median([4.0, 1.0, 2.0, 3.0]) == 2.5


def test_block_clock_on_time_and_after_a_dropout():
    period = 512 / 48000.0
    # a pull that returns inside its period: the next is due at the next boundary
    assert stats.next_issue(10.0, period, 10.0 + 0.3 * period) == pytest.approx(10.0 + period)
    # one that overruns by 1.5 periods skips the boundary it missed
    assert stats.next_issue(10.0, period, 10.0 + 2.5 * period) == pytest.approx(10.0 + 3 * period)
    # returned exactly on a boundary: the next one
    assert stats.next_issue(0.0, 1.0, 4.0) == pytest.approx(5.0)
