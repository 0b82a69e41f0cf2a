"""The whole model's share of the card's bf16 peak, in %: the operations
that the window's work needs (port_bench/flops.py: every encode finished in
the window at its 1500 frames, and every window decode finished in it, its
prompt rows and chosen tokens), over the window's seconds times 989 TFLOP/s."""

from port_bench import flops


def read(run):
    enc = sum(1 for t in run.probe.encodes if run.t0 <= t <= run.t1)
    dec = [(p, n) for t, p, n in run.probe.windows if run.t0 <= t <= run.t1]
    work = enc * flops.encoder_flops(run.hp) + flops.decoder_flops(run.hp, dec)
    return 100.0 * work / ((run.t1 - run.t0) * flops.PEAK_FLOPS)
