"""The program's own encode timer (ctx.timings t_encode_us, host clock to
a synchronise) summed over every request finished in the window, over the
windows those requests encoded, in ms."""


def read(run):
    done = [r["timings"] for r in run.probe.requests.values() if run.t0 <= r["end"] <= run.t1]
    n = sum(t["n_encode"] for t in done)
    return sum(t["t_encode_us"] for t in done) / n / 1e3 if n else None
