"""The port's whisper-cli output files against the JAX whisper-cli's, on
the decisive synthetic file and wav of test_torch_cli.py (its fixtures and
helpers are imported from there): text formats byte-equal, JSON equal
apart from `systeminfo` and token `p` within 2e-6 (see test_torch_cli.py).
Kept in a file of its own so that a worker of its own can run it.
"""

import json

import pytest

from test_torch_cli import (TEXT, _assert_json_equal, _run_both, files,  # noqa: F401
                            global_flags)


@pytest.mark.parametrize("flags", [[], ["-bs", "1"], ["-nfa"], ["-ml", "16", "-sow"]],
                         ids=["defaults_beam", "bs1_greedy", "nfa", "ml16_sow"])
def test_cli_outputs_match_jax(files, tmp_path, global_flags, flags):
    jbase, tbase = _run_both(files, tmp_path, flags)
    for ext in TEXT:
        with open(f"{jbase}.{ext}", "rb") as f:
            want = f.read()
        with open(f"{tbase}.{ext}", "rb") as f:
            got = f.read()
        assert got == want, ext
    assert want.count(b"\n") >= 4                 # both windows gave segments
    with open(f"{jbase}.json") as f:
        jj = json.load(f)
    with open(f"{tbase}.json") as f:
        tj = json.load(f)
    assert tj.pop("systeminfo") == "whisper_tpu_torch (PyTorch/CUDA)"
    jj.pop("systeminfo")
    assert all("tokens" in s for s in tj["transcription"])
    _assert_json_equal(tj, jj)
