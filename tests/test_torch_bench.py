"""The port's whisper-bench -w 0 (cli/bench_model.py) against the repo's
bench.py, on the CPU at a small size.

`bench_model` and `bench_parakeet` return the rows of bench.py's functions
of the same names (their keys read from bench.py's source), finite and
positive; `main` prints bench.py's JSON line: the same keys, and a metric
naming the same rows.  The timings are not compared: the host clock on
the CPU measures nothing of the card.  Each row runs one timed run of 4
decode steps here (REPS, N_STEPS).
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_stream import torch_one_thread  # noqa: F401
from whisper_tpu_torch.cli import bench_model as BM
from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams

REPO = Path(__file__).resolve().parents[1]
HP = WhisperHParams(n_vocab=51865, n_audio_ctx=64, n_audio_state=64,
                    n_audio_head=1, n_audio_layer=1, n_text_ctx=448,
                    n_text_state=64, n_text_head=1, n_text_layer=2, n_mels=80)
PK = ParakeetHParams(n_vocab=8, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                     n_mels=16, n_fft=64, n_subsampling_channels=4, n_conv_kernel=3,
                     n_pred_dim=16, n_tdt_durations=2, tdt_durations=(0, 1))


def bench_py_keys(fn: str) -> list:
    """The keys of the dict that bench.py's `fn` returns."""
    tree = ast.parse((REPO / "bench.py").read_text())
    f = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)
    ret = f.body[-1]                 # return dict(model=..., ...)
    assert isinstance(ret, ast.Return)
    return [k.arg for k in ret.value.keywords]


@pytest.fixture
def quick(monkeypatch):
    monkeypatch.setattr(BM, "REPS", 1)
    monkeypatch.setattr(BM, "N_STEPS", 4)


def test_bench_model_rows(quick):
    r = BM.bench_model("small-test", HP, device="cpu")
    assert list(r) == bench_py_keys("bench_model")
    assert r["model"] == "small-test" and r["n_windows"] == 16
    for k, v in r.items():
        if k.endswith("_ms") or k.startswith("rtf"):
            assert np.isfinite(v) and v > 0, k


def test_bench_parakeet_rows(quick):
    r = BM.bench_parakeet(PK, device="cpu")
    assert list(r) == bench_py_keys("bench_parakeet")
    assert all(np.isfinite(v) and v > 0 for v in r.values())


def test_bench_main_line(quick, monkeypatch, capsys):
    monkeypatch.setitem(BM.DIMS, "small-test", HP)
    monkeypatch.setenv("WTPU_BENCH_MODEL", "small-test")
    monkeypatch.setenv("WTPU_BENCH_TURBO", "0")
    real = BM.bench_parakeet
    monkeypatch.setattr(BM, "bench_parakeet", lambda device=None: real(PK, device))
    rows = BM.main(device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["unit"] == "x realtime" and line["value"] == rows["rtf_batched"]
    assert line["vs_baseline"] == round(rows["rtf_batched"] / BM.BASELINE_RTF, 3)
    m = line["metric"]
    assert m.startswith("e2e realtime factor, small-test ") and "1 card (CPU)" in m
    for key in ("enc_ms", "dec_ms", "dec_q_ms", "dec_q8_ms", "prompt_ms", "enc_b_ms"):
        assert str(rows[key]) in m, key
    assert f"TDT decode {rows['parakeet']['pk_dec_ms']}ms" in m
    # bench.py's published V100 yardstick, unchanged
    assert round(BM.BASELINE_RTF, 1) == 58.0
