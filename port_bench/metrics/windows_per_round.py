"""Windows decoded over the batcher's rounds, both counted by the program
over the window (WindowBatcher.n_rounds, the window decoders' `windows`)."""


def read(run):
    rounds = run.counters["rounds"]
    return run.counters["windows"] / rounds if rounds else None
