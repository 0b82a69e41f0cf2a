"""The decoder window loop's share of its roofline, in %: for every
window-decode call in the traced window, the bound of its prompt pass and
of each step its windows' chosen tokens need (q5_0 weights once a step,
f16 cross and self K/V of the windows still decoding, or operations if
larger; port_bench/flops.py), over the device time inside the benchmark's
spans around those calls."""

from port_bench import flops


def read(run):
    t = run.trace
    if t is None or not t.span_device_s.get("decode"):
        return None
    bound = sum(flops.group_bound_s(run.hp, w) for w in t.decode_windows)
    return 100.0 * bound / t.span_device_s["decode"]
