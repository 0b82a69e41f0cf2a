"""The window loop's host issue time of a round's prompt pass and state
load, in ms: the mean of the program's `round.prompt` spans ended in the
window (rounds that captured graphs record none)."""

from port_bench import spans


def read(run):
    return spans.mean_ms(run, "round.prompt")
