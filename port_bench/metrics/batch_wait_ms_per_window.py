"""A window decode's wait in the batcher's queue, in ms: the mean of the
program's `batch.wait` spans ended in the window, each from the window's
arrival to the take of its round."""

from port_bench import spans


def read(run):
    return spans.mean_ms(run, "batch.wait")
