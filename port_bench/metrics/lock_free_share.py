"""Share of the window in which no thread held the program's device lock,
in %: 1 less the union of the program's `lock.hold` spans (outermost
holds of DEVICE_LOCK) that overlap [t0, t1], clipped to it."""

from port_bench import spans


def read(run):
    held = spans.covered_share(run, "lock.hold")
    return None if held is None else 100.0 * (1.0 - held)
