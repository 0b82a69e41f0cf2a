"""The control at a size a test run holds: the reference in fp8 put in the
program's place reads far above the program on every continuous number,
and fails the limits the benchmark's configurations set (port_bench/control.py
reads the same at the cells' own sizes on the card)."""

import json
import os
import time

from port_bench import run as R
from port_bench.reference.check import NAMES

from test_port_bench_faults import HERE, tiny_bench

CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def test_control_reads_above_the_program_and_fails_the_limits():
    res = R.run_cell(tiny_bench(), "tiny", 424242, 4.0, False, device="cpu",
                     traffic_dir=os.path.join(HERE, "data"), t_start=time.monotonic(),
                     control=True)
    assert res["correct"], res["checks"]
    prog = {k: c["value"] for k, c in res["checks"].items()}
    ctrl = res["control"]["numbers"]
    assert set(ctrl) == set(NAMES)
    assert not res["control"]["correct"]
    for k in ("mel", "enc", "xkv", "prompt", "logprob"):
        assert ctrl[k] >= 3 * prog[k], (k, ctrl[k], prog[k])
    for name in os.listdir(CONFIGS):
        with open(os.path.join(CONFIGS, name)) as f:
            limits = json.load(f)["limits"]
        assert any(ctrl[k] > limits[k] for k in NAMES), (name, ctrl, limits)
