"""The encoder's share of its roofline, in %: the bound of one window
(the larger of its operations over 989 TFLOP/s and its bytes over 3.35
TB/s, port_bench/flops.py) times the encodes in the traced window, over the
device time inside the benchmark's spans around those encode calls (the
window's mel copied in, the stem, the blocks and the cross K/V), whatever
kernels ran."""

from port_bench import flops


def read(run):
    t = run.trace
    if t is None or not t.span_device_s.get("encode"):
        return None
    return 100.0 * flops.encoder_bound_s(run.hp) * t.span_count["encode"] / t.span_device_s["encode"]
