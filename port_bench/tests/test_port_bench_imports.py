"""What a run loads: no JAX and nothing of the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""

import subprocess
import sys

from port_bench import run as R

ROOT = R.ROOT


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "whisper_tpu_torch_fake_mod", object())
    monkeypatch.delitem(sys.modules, "whisper_tpu", raising=False)
    assert "whisper_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "whisper_tpu.fake", object())
    assert "whisper_tpu" in R.forbidden_modules()


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
                          "for m in sys.modules}))"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    mods = _loaded("import port_bench.run as R, port_bench.probe, port_bench.devtrace, "
                   "port_bench.control, port_bench.reference.check\n"
                   "import whisper_tpu_torch.cli.server\n"
                   "[R._reader(m['name']) for m in R.load_bench()['end_to_end'] + "
                   "R.load_bench()['per_layer']]")
    assert not set(mods) & set(R.FORBIDDEN)
    assert "whisper_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import port_bench.reference.whisper_ref, port_bench.reference.check")
    assert not set(mods) & (set(R.FORBIDDEN) | {"whisper_tpu_torch"})
