"""95th percentile (nearest rank) of the latency of every request answered
inside the window, from its due time to its response read (host clock)."""

from port_bench import stats


def read(run):
    lat = stats.latencies(run.records, run.t0, run.t1)
    return stats.percentile(lat, 0.95) if lat else None
