"""The port covers the JAX package's whole public surface.

An AST walk over every module of whisper_tpu/: each has a module of the
same path in whisper_tpu_torch/, and each public name the JAX module
defines at its top level (a function, a class or an assigned name not
starting with "_") is a top-level name of the port's module (defined or
imported there).  The exceptions are XLA compile forms and a device path
under another name, each with the port's counterpart, which must exist:

- `models/whisper/model.py scan_layers` (`lax.scan` over stacked layers,
  with JAX's `unroll_layers`): the port's Python loop over the layers;
- `models/parakeet/mel.py log_mel_spectrogram_jax` (the device mel):
  `log_mel_spectrogram_torch`.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "whisper_tpu", REPO / "whisper_tpu_torch"
# (module, JAX name) -> the port's counterpart in the same module, or None
# for a compile form the port's plain loop stands for
MAPPED = {
    ("models/whisper/model.py", "scan_layers"): None,
    ("models/parakeet/mel.py", "log_mel_spectrogram_jax"): "log_mel_spectrogram_torch",
}
MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _defined(tree) -> set:
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _top_level(tree) -> set:
    out = _defined(tree)
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def test_walk_sees_the_package():
    assert len(MODULES) > 50 and "models/whisper/model.py" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_port_counterparts(module):
    port = PORT / module
    assert port.exists(), f"no port module for whisper_tpu/{module}"
    public = {n for n in _defined(ast.parse((JAX / module).read_text()))
              if not n.startswith("_")}
    have = _top_level(ast.parse(port.read_text()))
    missing = set()
    for name in public - have:
        if (module, name) not in MAPPED:
            missing.add(name)
        elif MAPPED[(module, name)] is not None:
            assert MAPPED[(module, name)] in have, (module, name)
    assert not missing, f"whisper_tpu/{module}: no port counterpart for {sorted(missing)}"


def test_mapped_names_are_still_in_the_jax_package():
    for module, name in MAPPED:
        assert name in _defined(ast.parse((JAX / module).read_text()))
