"""CUDA graphs the program captured inside the window (its window
decoders' `graphs` counters): a round width or prompt bucket the warm-up
did not meet, captured while the clock runs."""


def read(run):
    return run.counters["graphs"]
