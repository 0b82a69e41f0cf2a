"""The port's whisper-stream against the JAX package's, on the CPU.

Both CLIs run through `main()` (the port with -ng) on the same DECISIVE
synthetic file (tests/test_torch_cli.py's widths and seed) and the same
seeded wav (12 s; 5 s for the VAD mode), with -nf (t = 0 greedy): fixed-step mode (--step 3000
--length 10000, --no-realtime), the same with -ac 768 (the encoder over 768
frames), and the energy-VAD mode (--step 0).  The printed output must be
equal.  With --no-realtime the VAD mode reads the whole file before its
first 2 s have passed and so never transcribes; it plays the file back in
real time instead, on chip_smoke.py's simulated clock (`SimClock`: every
sleep advances it, nothing else does), so the playback and each transcription's printed
t0/t1 are the same in every run and the test does not wait in real time.
"""

import io
import re

import numpy as np
import pytest
import torch

from chip_smoke import SimClock
from whisper_tpu.cli import stream as JS
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import stream as TS
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """One intra-op thread for the port's side: these tests run many small
    tensor ops, which a thread pool does not speed up, and under the
    suite's xdist workers eight threads a worker oversubscribe the cores
    (the other test files of this slice import this fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def voice_clip(seconds: float, tail: float, seed: int) -> np.ndarray:
    """Seeded noise at speech level, then a quiet `tail`: the energy VAD
    (vad_simple) sees speech end in the clip's last 2 s."""
    rng = np.random.default_rng(seed)
    n, n_tail = int(16000 * seconds), int(16000 * tail)
    x = 0.1 * rng.standard_normal(n)
    x[n - n_tail:] *= 0.02
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    model = str(d / "decisive-q5_0.bin")
    write_synth_model(model, HP, seed=1, qtype="q5_0", decisive=True)
    wavs = {}
    for name, seconds in (("fixed", 12.0), ("vad", 5.0)):
        wavs[name] = str(d / f"audio-{name}.wav")
        write_wav(wavs[name], voice_clip(seconds, 1.5, seed=5))
    return model, wavs


def run_main(mod, model, wav, flags, monkeypatch):
    """`mod.main(...)`'s printed output: run_stream's `out` defaults to the
    sys.stdout of import time, so main's call is given a buffer.  Without
    --no-realtime the playback runs on a SimClock."""
    buf = io.StringIO()
    run_stream = mod.run_stream
    monkeypatch.setattr(mod, "run_stream",
                        lambda ctx, source, args: run_stream(ctx, source, args, out=buf))
    if "--no-realtime" not in flags:
        monkeypatch.setattr(mod, "time", SimClock())
    assert mod.main(["-m", model, "-f", wav, "-nf", *flags]) == 0
    return buf.getvalue()


STREAM_FLAGS = {
    "fixed_step": ["--step", "3000", "--length", "10000", "--no-realtime"],
    "fixed_step_ac768": ["--step", "3000", "--length", "10000", "-ac", "768",
                         "--no-realtime"],
    "vad": ["--step", "0", "--length", "10000"],
}


@pytest.mark.parametrize("mode", list(STREAM_FLAGS))
def test_stream_matches_jax(files, mode, monkeypatch):
    flags = STREAM_FLAGS[mode]
    model, wavs = files
    wav = wavs["vad" if mode == "vad" else "fixed"]
    want = run_main(JS, model, wav, flags, monkeypatch)
    got = run_main(TS, model, wav, flags + ["-ng"], monkeypatch)
    if mode == "vad":
        assert "### Transcription 0 START" in got and "-->" in got
    else:
        # each step clears the line before its text
        assert got.count("\33[2K\r") >= 4
    assert got == want
    assert re.search(r"[a-z]{2,}", got)


def test_stream_without_a_card_raises(files):
    # this host has no CUDA card: without -ng the context raises
    model, wavs = files
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.main(["-m", model, "-f", wavs["fixed"], "--no-realtime"])
