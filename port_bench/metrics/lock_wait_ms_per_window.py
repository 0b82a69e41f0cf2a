"""The wait for the program's device lock per window, in ms: the sum of
the program's `lock.wait` spans (outermost acquisitions of DEVICE_LOCK)
ended in the window, over its `seek.window` spans ended in it."""

from port_bench import spans


def read(run):
    wins = spans.ended(run, "seek.window")
    if not wins:
        return None
    return sum(s.t1 - s.t0 for s in spans.ended(run, "lock.wait")) / len(wins) / 1e6
