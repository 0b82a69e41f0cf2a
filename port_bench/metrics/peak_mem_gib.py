"""torch.cuda.max_memory_allocated() over the program's set-up and the
window, in GiB (read by the benchmark before its reference runs)."""


def read(run):
    return run.peak_bytes / 2 ** 30
