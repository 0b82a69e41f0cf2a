"""The encoder's host issue time per window, in ms: the mean of the
program's `encode.issue` spans ended in the window, each from the device
lock held to the encoder and the cross K/V projection returned, before the
synchronise (the eager encoder's launches as the host issues them)."""

from port_bench import spans


def read(run):
    return spans.mean_ms(run, "encode.issue")
