"""Readings for the limits of `correct`: the program's numbers and the
control's over several seeds, in one process.

    python3 -m port_bench.control --workload <name> --seeds 11,12,13 --seconds 5

For each seed, one run of the cell with a short window (the mix's own
load, long enough to finish its longest requests); the requests the run
drew are then compared twice: the served outputs against the reference
(the program's numbers), and the control, the reference in fp8 put in the
program's place at the same prompts and tokens, against the reference
(the control's numbers), and each side is judged by the limits the
benchmark's runs apply (`correct` and `control_correct`, which has to be
false).  One JSON line per seed on standard output, then a summary: the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    bench = R.load_bench()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            res = R.run_cell(bench, args.workload, seed, args.seconds, False,
                             t_start=time.monotonic(), control=True)
        except R.RunFailed as e:
            R.log(f"seed {seed}: run failed: {e}")
            return 3
        row = {"seed": seed, "correct": res["correct"],
               "control_correct": res["control"]["correct"],
               "program": {k: c["value"] for k, c in res["checks"].items()},
               "control": res["control"]["numbers"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"]
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "correct": sum(r["correct"] for r in rows),
                      "control_correct": sum(r["control_correct"] for r in rows),
                      "program_max": {k: max(r["program"][k] for r in rows) for k in names},
                      "control_min": {k: min(r["control"][k] for r in rows) for k in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
