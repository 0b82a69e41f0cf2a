"""Seconds from the process's start to the window's start: imports, the
model drawn and written, the program's load(), its kernels built or found,
and the warm-up with the cell's own traffic (host clock)."""


def read(run):
    return run.setup_s
