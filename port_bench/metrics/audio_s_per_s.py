"""Seconds of audio in every request answered inside the window, over the
window's seconds (host clock)."""

from port_bench import stats


def read(run):
    return stats.audio_rate(run.records, run.t0, run.t1)
