"""The port's two scale-out tools end to end on gloo CPU ranks, as a user
runs them: `python -m whisper_tpu_torch.parallel.scaling_bench` (the
counterpart of tools/scaling_bench.py) and `python -m
whisper_tpu_torch.parallel.collective_audit` (of tools/collective_audit.py).

The scaling bench at tiny dims: 1x1 and 2x1 give one well-formed JSON line
each (the JAX tool's keys, positive tokens/s, the first configuration's
efficiency 1.0), and a configuration past the devices or with a tp that
does not divide the heads gives a skip line.  The audit prints the JAX
tool's table with its tp = 1 row, and a skip row for a tp that does not
divide the heads.  Throughput on shared CPU cores is not a speed figure.
"""

import contextlib
import io
import json

from whisper_tpu_torch.parallel import collective_audit as CA
from whisper_tpu_torch.parallel import scaling_bench as SB

KEYS = ["config", "devices", "dp", "tp", "model", "windows_total", "tok_s",
        "efficiency_vs_linear"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_scaling_bench_lines(monkeypatch):
    # gloo ranks count the CPU's cores as the devices: four here
    monkeypatch.setattr(SB.os, "cpu_count", lambda: 4)
    lines = [json.loads(s) for s in _run(SB.main, [
        "--model", "tiny", "--configs", "1x1,2x1,8x1,1x4", "--windows", "2", "--steps", "8"])]
    assert [d["config"] for d in lines] == ["1x1", "2x1", "8x1", "1x4"]
    one, two = lines[:2]
    for d, (dp, n) in ((one, (1, 1)), (two, (2, 2))):
        assert list(d) == KEYS
        assert (d["dp"], d["tp"], d["devices"], d["model"]) == (dp, 1, n, "tiny")
        assert d["windows_total"] == 2 * dp and d["tok_s"] > 0
        assert 0 < d["efficiency_vs_linear"] < 10
    assert one["efficiency_vs_linear"] == 1.0
    assert lines[2] == {"config": "8x1", "skipped": "needs 8 devices, have 4"}
    assert lines[3] == {"config": "1x4", "skipped": "tp=4 does not divide 6 heads"}


def test_collective_audit_table():
    lines = _run(CA.main, ["--layers", "1", "--state", "64", "--heads", "2", "--beams", "2",
                           "--tp", "1", "2", "3"])
    assert lines[:3] == CA.header(1, 64, 2, 2, "f16")
    assert lines[3] == "| 1 | none | 0.00 | 0.0 KiB |"
    assert lines[4] == "| 2 | 3 all-reduce | 3.00 | 1.5 KiB |"
    assert lines[5].split() == ["all-reduce", "f32[2,1,64]", "x3", "512", "B", "each"]
    assert lines[6] == "| 3 | skipped: tp=3 does not divide 2 heads | | |"
