"""The port's whisper-cli and whisper-bench against the JAX package's.

whisper-cli: the port with -ng (the CPU) and the JAX CLI (CPU) on the same
DECISIVE synthetic file (n_text_layer 3, so timestamps are on) and the same
seeded wav, at the default flags (beam 5, best-of 5), at -bs 1 (greedy), at
-nfa, at -ml 16 -sow and at -p 2 (two chunks batched natively).  The text
formats must be byte-equal.  The JSON files must be equal once parsed, with
`systeminfo` set aside (it names the package) and each token's `p` within
2e-6: the writer rounds p to six decimals, and the two packages' f32 sums
differ in order, which can move the sixth decimal by one.  The -p 1
comparisons live in test_torch_cli_outputs.py, which imports this file's
fixtures.

whisper-bench: -w 1 and -w 2 at a small size on the CPU print the JAX
package's line formats; without a card the commands raise.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from whisper_tpu.cli import transcribe as JC
from whisper_tpu.ops import attention as JA
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import bench_cli as TB
from whisper_tpu_torch.cli import transcribe as TC
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.ops import attention as TA
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
TEXT = ("txt", "vtt", "srt", "csv", "lrc")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = str(d / "decisive-q5_0.bin")
    write_synth_model(model, HP, seed=1, qtype="q5_0", decisive=True)
    wav = str(d / "audio.wav")
    write_wav(wav, (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)
                    ).astype(np.float32))
    return model, wav


@pytest.fixture
def global_flags():
    """-nfa sets both packages' flash switch and the WTPU_* variables of
    this process: restore them after each run."""
    env = {k: os.environ.get(k) for k in ("WTPU_ENC_ATTN", "WTPU_DECODE_ATTN")}
    yield
    JA.set_flash_enabled(True)
    TA.set_flash_enabled(True)
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _run_both(files, tmp_path, flags):
    model, wav = files
    outs = {}
    for name, mod, extra in (("jax", JC, []), ("torch", TC, ["-ng"])):
        of = str(tmp_path / name)
        rc = mod.run(["-m", model, "-f", wav, "-otxt", "-ovtt", "-osrt", "-ocsv",
                      "-olrc", "-oj", "-ojf", "-of", of, "-np", *flags, *extra])
        assert rc == 0, name
        outs[name] = of
    return outs["jax"], outs["torch"]


def _assert_json_equal(a, b, where="json"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            if k == "p":
                assert abs(a[k] - b[k]) <= 2e-6, (where, a[k], b[k])
            else:
                _assert_json_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def test_cli_processors_match_jax(files, tmp_path, global_flags):
    # -p 2: two chunks whose windows batch natively (decoding/parallel.py),
    # at the default flags (beam 5, best-of 5); the text formats byte-equal
    # and the JSON equal, as test_torch_cli_outputs.py holds -p 1
    jbase, tbase = _run_both(files, tmp_path, ["-p", "2"])
    for ext in TEXT:
        with open(f"{jbase}.{ext}", "rb") as f:
            want = f.read()
        with open(f"{tbase}.{ext}", "rb") as f:
            assert f.read() == want, ext
    assert want.count(b"\n") >= 2
    with open(f"{jbase}.json") as f:
        jj = json.load(f)
    with open(f"{tbase}.json") as f:
        tj = json.load(f)
    jj.pop("systeminfo")
    tj.pop("systeminfo")
    _assert_json_equal(tj, jj)


def _run_module(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_without_a_card_raises_unless_ng(files):
    # this host has no CUDA card: the default device raises, -ng runs
    model, wav = files
    r = _run_module(["whisper_tpu_torch.cli.transcribe", "-m", model, "-f", wav])
    assert r.returncode != 0 and "CUDA" in r.stderr
    r = _run_module(["whisper_tpu_torch.cli.transcribe", "-m", model, "-f", wav,
                     "-ng", "-bs", "1", "-nf", "-np"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("-->") >= 4


def test_bench_without_a_card_raises():
    # -w 0 (cli/bench_model.py) runs on the card too, as -w 1 and -w 2 do
    for w in ("0", "1", "2"):
        r = _run_module(["whisper_tpu_torch.cli.bench_cli", "-w", w])
        assert r.returncode != 0 and "CUDA" in r.stderr, w


def test_bench_memcpy_line_format(capsys):
    assert TB.bench_memcpy(n=1 << 16, device="cpu") == 0
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"memcpy: +-?[\d.]+ GB/s \(device read\+write, [\d.]+ MB buffer\)",
                        line), line


def test_bench_mul_mat_line_format(capsys):
    from whisper_tpu_torch.ops import qmm as QM

    before = QM.qmm.launches
    assert TB.bench_mul_mat(n=128, device="cpu") == 0
    assert QM.qmm.launches == before               # the CPU takes qmm_plain
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"mul_mat 128x128: bf16 +-?[\d.]+ TFLOPS", lines[0]), lines[0]
    assert re.fullmatch(r"mul_mat 128x128: q5_0 fused dequant +-?[\d.]+ TFLOPS",
                        lines[1]), lines[1]


def test_cli_profile_writes_a_trace(files, tmp_path, capsys):
    # --profile DIR: a torch.profiler Chrome trace of the transcription
    model, wav = files
    out = tmp_path / "prof"
    rc = TC.run(["-m", model, "-f", wav, "-ng", "-bs", "1", "-nf", "--profile", str(out)])
    assert rc == 0
    traces = list(out.glob("trace-*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert "profiler trace written to" in capsys.readouterr().err
