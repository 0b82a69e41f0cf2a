"""One run of one cell of the port's benchmark.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json `workloads`) names
a configuration (its file, `configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`); every metric is a reader of its own,
`metrics/<name>.py`, found by its name.

The run: the model drawn on the card from the seed and written into
anonymous memory; the port's whisper-server (`whisper_tpu_torch.cli.server`)
loads it and serves on 127.0.0.1; a child process offers the mix; the
warm-up runs the mix until a pass of it captures no new CUDA graph; then
the window is measured with the clients already running (`--trace 1`:
its first TRACE_S seconds under the profiler, which give the per-layer
metrics).  After the window the clients stop, the memory peak is
read and the program is freed, and the plain reference
(port_bench/reference) checks the requests drawn from the seed.  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when the run could not finish (no result printed).
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import mmap  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from . import stats, traffic  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")
DRAIN_S = 90.0
TRACE_S = 20.0


class RunFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, trace: bool):
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _window_fns(ctx):
    return list(ctx._window_fns.values())


def _counters(state) -> dict:
    ctx, batcher = state.ctx, state.batcher
    fns = _window_fns(ctx)
    return {"rounds": batcher.n_rounds, "windows": sum(f.windows for f in fns),
            "graphs": sum(f.graphs for f in fns)}


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, traffic_dir: str = HERE,
             t_start: float = T_START, control: bool = False) -> dict:
    """Run one cell once; returns the result's fields (see module doc).
    `control` (port_bench/control.py, never the benchmark's runs) also reads
    the control's numbers, under the result's key "control"."""
    import torch

    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    mix = traffic.load(wl["traffic"], traffic_dir)
    on_card = device == "cuda"

    # the load generator makes its audio while the model is drawn and loaded
    mp = multiprocessing.get_context("spawn")
    parent_conn, child_conn = mp.Pipe()
    from . import loadgen
    child = mp.Process(target=loadgen.main, args=(child_conn, mix, seed), daemon=True)
    child.start()

    from . import model_file
    from .probe import Probe
    chosen = np.random.default_rng([seed, 4]).choice(
        mix.clients, size=min(mix.sample_clients, mix.clients), replace=False)
    probe = Probe([int(c) for c in chosen], int(np.argmax(mix.lengths_s)), trace)
    httpd = server_thread = None
    try:
        t = time.monotonic()
        fd, path, size = model_file.write_memfd(cfg, seed, device)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        log(f"setup: model drawn and written, {size} bytes, {time.monotonic() - t:.3f} s")
        probe.install()
        from whisper_tpu_torch.cli import server as S
        t = time.monotonic()
        httpd = S.serve(path, "127.0.0.1", 0, defaults={"language": "en"},
                        device=None if on_card else device)
        state = httpd.whisper_state
        state.ensure_loaded()
        log(f"setup: load() {time.monotonic() - t:.3f} s")
        server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        server_thread.start()
        if not parent_conn.poll(120) or parent_conn.recv()[0] != "ready":
            raise RunFailed("the load generator did not get ready")
        parent_conn.send(("go", "127.0.0.1", httpd.server_address[1]))
        _warm_up(mix, probe, state, child)

        prof = mark0 = None
        if trace:
            from . import devtrace
            prof = devtrace.start()
            mark0 = devtrace.marker()
        t0 = time.monotonic()
        probe.t0, probe.t1 = t0, t0 + seconds
        setup_s = t0 - t_start
        c0 = _counters(state)
        # a traced run's per-layer metrics come from its first TRACE_S
        # seconds (a trace of the whole window takes minutes to reduce);
        # the clients run on to the window's end all the same
        t1 = t0 + (min(seconds, TRACE_S) if trace else seconds)
        time.sleep(max(0.0, t1 - time.monotonic()))
        c1 = _counters(state)
        mark1 = devtrace.marker() if trace else None
        if trace:
            prof.stop()
            time.sleep(max(0.0, probe.t1 - time.monotonic()))
        parent_conn.send(("stop",))
        if not parent_conn.poll(DRAIN_S):
            raise RunFailed("the load generator did not stop")
        _, records, alive = parent_conn.recv()
        child.join(30)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        counters = {k: c1[k] - c0[k] for k in c0}
        n_done = len(stats.in_window(records, t0, probe.t1))
        log(f"window: {seconds} s; graphs captured in it: {counters['graphs']}; "
            f"rounds {counters['rounds']}, windows {counters['windows']}; requests answered "
            f"{n_done}, {stats.beyond(n_done, 0.95) if n_done else 0} beyond the p95; "
            f"clients still busy at the drain's end: {alive}")
    finally:
        if server_thread is not None:
            httpd.shutdown()
            server_thread.join(30)
        if httpd is not None:
            httpd.server_close()
            httpd.whisper_state.ctx = httpd.whisper_state.batcher = None
        probe.uninstall()
        if child.is_alive():
            child.kill()
            child.join(10)
    httpd = state = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    for e in probe.errors[:3]:
        log(f"server error: {e}")

    tr = None
    if trace:
        from . import devtrace
        t = time.monotonic()
        tr = devtrace.reduce(prof, mark0, mark1, probe.spans)
        prof = None
        log(f"trace: {tr.n_events if tr else 0} device events reduced in "
            f"{time.monotonic() - t:.3f} s; marker drift {tr.drift_us if tr else 0:.1f} us")

    hp = model_file.hparams(cfg)
    run = SimpleNamespace(hp=hp, t0=t0, t1=t1, setup_s=setup_s, records=records,
                          probe=probe, peak_bytes=peak, counters=counters, trace=tr)
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        v = _reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    window = stats.in_window(records, t0, probe.t1)
    failed = sum(1 for r in window if r[5] != 200)
    t = time.monotonic()
    checks, notes, n_checked, ctrl = _check(cfg, fd, device, probe, records, mix, seed, control)
    log(f"check: {n_checked} requests in {time.monotonic() - t:.3f} s")
    for n in notes:
        log(f"check: {n}")
    os.close(fd)

    bad = forbidden_modules()
    if bad:
        raise RunFailed(f"modules loaded that the port must not load: {bad}")
    correct = failed == 0 and within_limits(checks, n_checked)
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": _device(torch, on_card, peak, tr)}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    if control:
        numbers = {k: {"value": v, "limit": checks[k]["limit"]} for k, v in ctrl.items()
                   if k in checks}
        result["control"] = {"numbers": ctrl, "correct": within_limits(numbers, n_checked)}
    result["checks"] = checks
    return result


def within_limits(checks: dict, n_checked: int) -> bool:
    """The comparison's verdict on the numbers compared: some requests
    checked, and every number at or under its limit."""
    return n_checked > 0 and all(c["value"] <= c["limit"] for c in checks.values())


def _warm_up(mix, probe, state, child) -> None:
    """Run the mix until `quiet_passes` passes in a row (a pass: as many
    requests as the mix has lengths, or clients if more) capture no new
    CUDA graph, and at least `min_passes` passes.  A warm-up still
    capturing after `max_s` seconds fails the run: the window is not
    opened on a program still warming up."""
    per_pass = max(len(mix.lengths_s), mix.clients)
    min_passes = int(mix.warmup.get("min_passes", 2))
    quiet_passes = int(mix.warmup.get("quiet_passes", 1))
    max_s = float(mix.warmup.get("max_s", 150))
    t_go = time.monotonic()
    passes, last, quiet = 0, None, 0
    while True:
        target = per_pass * (passes + 1)
        while len(probe.requests) < target:
            if probe.errors:
                raise RunFailed(f"the server failed a warm-up request: {probe.errors[0]}")
            if not child.is_alive():
                raise RunFailed("the load generator died")
            if time.monotonic() - t_go > max_s:
                raise RunFailed(f"the warm-up still captured graphs after {max_s} s "
                                f"(pass {passes + 1})")
            time.sleep(0.05)
        passes += 1
        g = sum(f.graphs for f in _window_fns(state.ctx))
        log(f"warm-up: pass {passes} done at {time.monotonic() - t_go:.3f} s, "
            f"{len(probe.requests)} requests, {g} graphs")
        quiet = quiet + 1 if g == last else 0
        if passes >= min_passes and quiet >= quiet_passes:
            return
        last = g


def _check(cfg, fd, device, probe, records, mix, seed, control=False):
    """The reference over the requests drawn: (checks, notes, requests,
    the control's numbers or None)."""
    import torch
    from .reference import check as C
    from .reference.whisper_ref import Whisper

    by_rid = {r[0]: r for r in records}
    size = os.fstat(fd).st_size
    with mmap.mmap(fd, size, access=mmap.ACCESS_READ) as buf:
        ref = Whisper(buf, device)
        ctrl = Whisper(buf, device, precision="fp8") if control else None
    rules = C.Rules(ref.hp, ref.vocab)
    tally, ctrl_tally = C.Tally(), C.Tally()
    n = 0
    for rid, sample in sorted(probe.samples.items()):
        rec = by_rid.get(rid)
        if rec is None or rec[5] != 200:
            tally.miss(f"{rid}: drawn for the check but not answered")
            continue
        c, _, li = (int(x) for x in rid.split(":"))
        pcm = traffic.served_pcm(traffic.audio(seed, c, li, mix.lengths_s[li]))
        C.check_request(ref, rules, pcm, rec[6], sample, tally, ctrl, ctrl_tally)
        n += 1
    del ref, ctrl
    if device == "cuda":
        torch.cuda.empty_cache()
    m = np.array(tally.margins) if tally.margins else np.zeros(1)
    notes = tally.notes + [f"{n} requests, {tally.n_windows} windows, "
                           f"{tally.n_tokens} tokens compared; the reference's top-2 "
                           f"margins min {m.min():.3f} p10 {np.quantile(m, 0.1):.3f} "
                           f"median {np.median(m):.3f}"]
    limits = cfg["limits"]
    checks = {k: {"value": _finite(tally.v[k]), "limit": limits[k]} for k in C.NAMES
              if k in limits}
    notes.append("not compared (no limit separates the program from the control): " + ", ".join(
        f"{k} {tally.v[k]!r}" for k in C.NAMES if k not in limits))
    return checks, notes, n, ({k: _finite(v) for k, v in ctrl_tally.v.items()}
                              if control else None)


def _finite(x: float) -> float:
    return float(x) if math.isfinite(x) else 1e30


def _device(torch, on_card: bool, peak: int, tr) -> dict:
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit"] = _power_limit()
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 3
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        log(f"the cell needs {wl['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except RunFailed as e:
        log(f"run failed: {e}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
