"""The share of encodes that replayed the program's encoder CUDA graph
(ctx.timings n_encode_graph over n_encode), summed over every request
finished in the window, in %.  None where the program keeps no such
counter."""


def read(run):
    done = [r["timings"] for r in run.probe.requests.values() if run.t0 <= r["end"] <= run.t1]
    n = sum(t["n_encode"] for t in done)
    if not n or not all("n_encode_graph" in t for t in done):
        return None
    return 100.0 * sum(t["n_encode_graph"] for t in done) / n
