"""The mel's time per request, in ms: the mean of the program's
`seek.mel` spans (a request's whole clip to its log-mel) ended in the
window."""

from port_bench import spans


def read(run):
    return spans.mean_ms(run, "seek.mel")
