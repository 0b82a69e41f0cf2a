"""Rate and percentile arithmetic, with a stall."""

import pytest

from port_bench import stats


def rec(done, lat, audio=10.0, status=200):
    return ("r", audio, done - lat, done - lat, done, status, "")


def steady(n=40):
    return [rec(1.0 + i * 0.25, 1.0) for i in range(n)]


def test_rate_counts_every_request_over_the_whole_window():
    r = steady()
    # 40 requests of 10 s answered in [1, 10.75]; the window [0, 11)
    assert stats.audio_rate(r, 0.0, 11.0) == pytest.approx(400.0 / 11.0)
    # a request answered outside the window or failed does not count
    r.append(rec(20.0, 1.0))
    r.append(rec(5.0, 1.0, status=500))
    assert stats.audio_rate(r, 0.0, 11.0) == pytest.approx(400.0 / 11.0)


def test_stall_lowers_the_rate_and_raises_the_tail():
    base = steady()
    # a 3 s stall: the requests after it land 3 s later and wait 3 s longer
    stalled = [rec(d + 3.0, lat + 3.0) if d > 6.0 else rec(d, lat)
               for (_, _, _, _, d, _, _), lat in zip(base, [1.0] * len(base))]
    t0, t1 = 0.0, 11.0
    assert stats.audio_rate(stalled, t0, t1) < stats.audio_rate(base, t0, t1)
    p_base = stats.percentile(stats.latencies(base, t0, t1), 0.95)
    p_stall = stats.percentile(stats.latencies(stalled, t0, t1), 0.95)
    assert p_base == pytest.approx(1.0) and p_stall == pytest.approx(4.0)


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert stats.percentile(v, 0.95) == 95
    assert stats.percentile(v, 0.5) == 50
    assert stats.percentile([7.0], 0.95) == 7.0
    assert stats.beyond(200, 0.95) == 10
    assert stats.beyond(100, 0.95) == 5
