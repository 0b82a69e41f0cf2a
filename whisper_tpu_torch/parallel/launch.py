"""N local ranks of one function.

The counterpart of tools/multihost_dryrun.py: `launch(target, n, args)`
starts n processes of this interpreter, each of which initialises the
default process group (parallel/multihost.py `init_distributed`) on a
file:// store in the launch's own temporary directory, calls
`target(*args)` and returns its value.  `launch` returns the values in
rank order.  No port is chosen ahead of the ranks (the collectives' own
sockets are bound by the backend as it connects), so launches that run
side by side, as test files under xdist do, cannot take each other's
rendezvous.

`target` is "module:function" or "path/to/file.py:function"; the ranks
import only that module (and what it imports), so a rank of a test that
holds the port to the JAX package imports no JAX.  Each rank sees
LOCAL_RANK and LOCAL_WORLD_SIZE = n (one host) and the WTPU_* variables.

Nothing is caught: a rank that raises fails the launch (the others are
killed and its standard error is in the RuntimeError), and a launch that
outlives `timeout` is killed and raises TimeoutError.

    python -m whisper_tpu_torch.parallel.launch -n 2 [--backend gloo] \\
        path/to/file.py:function        # prints each rank's value
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]


def _resolve(target: str):
    mod, _, fn = target.rpartition(":")
    if mod.endswith(".py"):
        path = Path(mod).resolve()
        spec = importlib.util.spec_from_file_location(path.stem, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[path.stem] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod)
    return getattr(module, fn)


def _tail(path: Path, n: int = 6000) -> str:
    data = path.read_bytes() if path.exists() else b""
    return data[-n:].decode(errors="replace")


def launch(target: str, n: int, args: Sequence[Any] = (), *, backend: str = "gloo",
           timeout: float = 600.0, threads: Optional[int] = None,
           echo: bool = False) -> List[Any]:
    """Run target(*args) on n local ranks; their return values in rank
    order.  `threads`: torch.set_num_threads in every rank (and the
    OpenMP variables), for ranks that share a few CPU cores.  `echo`: copy
    each rank's standard output to this one's when it ends."""
    with tempfile.TemporaryDirectory(prefix="wtpu-launch-") as tmp:
        work = Path(tmp)
        (work / "call.pkl").write_bytes(pickle.dumps((target, tuple(args))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.update(WTPU_COORDINATOR=(work / "rendezvous").as_uri(), WTPU_NUM_PROCESSES=str(n),
                   LOCAL_WORLD_SIZE=str(n), WTPU_LAUNCH_BACKEND=backend)
        if threads is not None:
            env.update(OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads),
                       WTPU_LAUNCH_THREADS=str(threads))
        procs = []
        for r in range(n):
            with open(work / f"out{r}.txt", "wb") as out, \
                    open(work / f"err{r}.txt", "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "whisper_tpu_torch.parallel.launch",
                     "--worker", tmp],
                    env={**env, "WTPU_PROCESS_ID": str(r), "LOCAL_RANK": str(r)},
                    stdout=out, stderr=err, cwd=str(REPO)))
        t_end = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = bad[0]
                    raise RuntimeError(
                        f"rank {r} of {n} exited with {codes[r]} ({target}):\n"
                        f"{_tail(work / f'err{r}.txt')}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > t_end:
                    raise TimeoutError(f"launch of {target} on {n} ranks passed "
                                       f"{timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if echo:
                for r in range(n):
                    sys.stdout.write(_tail(work / f"out{r}.txt", 1 << 20))
                sys.stdout.flush()
        return [pickle.loads((work / f"result{r}.pkl").read_bytes()) for r in range(n)]


def _worker(tmp: str) -> None:
    threads = os.environ.get("WTPU_LAUNCH_THREADS")
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(int(threads))
    from .multihost import init_distributed

    work = Path(tmp)
    target, args = pickle.loads((work / "call.pkl").read_bytes())
    init_distributed(backend=os.environ["WTPU_LAUNCH_BACKEND"])
    value = _resolve(target)(*args)
    rank = dist.get_rank()
    (work / f"result{rank}.pkl").write_bytes(pickle.dumps(value))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("-n", type=int, default=2, help="ranks")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("target", nargs="?", help="module:function or file.py:function")
    a = ap.parse_args(argv)
    if a.worker is not None:
        _worker(a.worker)
        return 0
    for r, v in enumerate(launch(a.target, a.n, backend=a.backend, timeout=a.timeout,
                                 echo=True)):
        print(f"rank {r}: {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
