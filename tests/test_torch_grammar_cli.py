"""The port's whisper-cli with --grammar and with --precision ggml_cpu_f16
against the JAX whisper-cli, on the CPU.

On the decisive file of tests/test_torch_cli.py (its fixtures and helpers
are imported from there) and the first 20 s of its wav (one window; the
grammar's host filter is Python over the vocabulary, ~50 ms a lane-step),
at the CLI's defaults (beam 5, best-of 5), with the committed
tests/data/text_parity/script.gbnf: text outputs byte-equal, the JSON
equal apart from `systeminfo` and token `p`.  A token's p moves by at most
p * 2 max |logit difference|.  The default mode's f32 logits sit some
1.2e-5 apart at the largest (~39), and the grammar's penalty keeps the
chosen tokens' p away from 1 (0.9, where the decisive runs without a
grammar sit at 1 - 1e-6 and tests/test_torch_cli.py holds p to 2e-6), so
--grammar holds p to 3e-5; the parity mode's f16 roundings move the
logits some 3e-4 of their largest apart
(tests/test_torch_parity_transcribe.py), so it holds p to 1e-3.
"""

import json
import os

import pytest

from test_torch_cli import REPO, TEXT, _run_both, files, global_flags  # noqa: F401
from whisper_tpu_torch.audio.io import load_audio, write_wav

GRAMMAR = os.path.join(REPO, "tests", "data", "text_parity", "script.gbnf")


@pytest.fixture(scope="module")
def short(files, tmp_path_factory):
    model, wav = files
    path = str(tmp_path_factory.mktemp("short") / "audio-20s.wav")
    write_wav(path, load_audio(wav)[0][:16000 * 20])
    return model, path


def _assert_json_close_p(a, b, tol, where="json"):
    """tests/test_torch_cli.py's _assert_json_equal with token `p` within
    `tol`."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            if k == "p":
                assert abs(a[k] - b[k]) <= tol, (where, a[k], b[k])
            else:
                _assert_json_close_p(a[k], b[k], tol, f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close_p(x, y, tol, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("flags", [
    ["--grammar", GRAMMAR, "--grammar-rule", "root"],
    ["--precision", "ggml_cpu_f16"],
    ["--precision", "ggml_cpu_f16", "-bs", "1"]],
    ids=["grammar_beam", "parity_beam", "parity_greedy"])
def test_cli_outputs_match_jax(short, tmp_path, global_flags, flags):
    jbase, tbase = _run_both(short, tmp_path, flags)
    for ext in TEXT:
        with open(f"{jbase}.{ext}", "rb") as f:
            want = f.read()
        with open(f"{tbase}.{ext}", "rb") as f:
            got = f.read()
        assert got == want, ext
    assert want.count(b"\n") >= 2
    with open(f"{jbase}.json") as f:
        jj = json.load(f)
    with open(f"{tbase}.json") as f:
        tj = json.load(f)
    assert tj.pop("systeminfo") == "whisper_tpu_torch (PyTorch/CUDA)"
    jj.pop("systeminfo")
    _assert_json_close_p(tj, jj, 3e-5 if "--grammar" in flags else 1e-3)
