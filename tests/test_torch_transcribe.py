"""The slice end to end: `whisper_tpu_torch.load` + `transcribe` on the CPU
against `whisper_tpu.load` + `transcribe` on the same synthetic q5_0 file.

The file is DECISIVE (utils/synth.py make_decisive): greedy argmax margins
sit far above f32 summation-order noise, so at t=0 the two packages must
give identical segments (text, t0, t1) and token ids.  Fallback attempts
at t>0 sample on the host from the reference's mt19937 stream in both
packages; only their completion is checked (t>0 agreement is
statistical, ROADMAP queue 3), while the t=0 attempts must still match:
test_torch_fallback.py, which imports this file's fixtures.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu_torch as W
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.models.whisper.model import CapturedWeight
from whisper_tpu_torch.utils.synth import write_synth_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    # two windows: ~35 s of seeded noise
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def _summary(segs):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]


def _record_windows(ctx):
    """Wrap ctx.decode_window_device to keep each t=0 attempt's tokens."""
    seen = []
    inner = ctx.decode_window_device

    def wrapped(prompt, n_beams, temperature, *a, **kw):
        res = inner(prompt, n_beams, temperature, *a, **kw)
        seen.append((list(prompt), float(temperature),
                     [list(np.asarray(res.tok_id[j, :int(res.n_tok[j])]))
                      for j in range(n_beams)]))
        return res

    ctx.decode_window_device = wrapped
    return seen


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_transcribe_matches_jax_at_t0(model_path, pcm, kv_itype):
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True,
                  kv_itype=kv_itype)
    ref = J.transcribe(jctx, J.TranscribeParams(temperature_inc=0.0), pcm)
    got = W.transcribe(tctx, W.TranscribeParams(temperature_inc=0.0), pcm)
    assert len(ref) >= 2                      # both windows produced text
    assert {s.t0 // 3000 for s in ref} == {0, 1}
    assert _summary(got) == _summary(ref)
    assert tctx.timings.n_encode == 2


def test_isolation_no_jax_in_process(model_path):
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import whisper_tpu_torch as W
        import whisper_tpu_torch.cli.server
        import whisper_tpu_torch.decoding.parallel
        import whisper_tpu_torch.runtime.batching
        import whisper_tpu_torch.models.vad.silero
        import whisper_tpu_torch.models.vad.pipeline
        import whisper_tpu_torch.decoding.dtw
        import whisper_tpu_torch.cli.vad_segments
        import whisper_tpu_torch.cli.parakeet_cli
        import whisper_tpu_torch.cli.parakeet_quantize
        import whisper_tpu_torch.capi
        import whisper_tpu_torch.abi
        import whisper_tpu_torch.native
        import whisper_tpu_torch.training.finetune
        import whisper_tpu_torch.cli.finetune
        from whisper_tpu_torch.models.parakeet.context import ParakeetContext
        from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
        from whisper_tpu_torch.models.parakeet.writer import (
            synth_parakeet_tensors, write_parakeet_model)
        ctx = W.load({model_path!r}, device="cpu")
        pcm = (0.1 * np.random.default_rng(0).standard_normal(16000 * 3)).astype(np.float32)
        W.transcribe(ctx, W.TranscribeParams(temperature_inc=0.0), pcm)
        hp = ParakeetHParams(n_vocab=8, n_audio_state=16, n_audio_head=2,
                             n_audio_layer=1, n_mels=16, n_fft=64,
                             n_subsampling_channels=4, n_conv_kernel=3,
                             n_pred_dim=16, n_tdt_durations=2,
                             tdt_durations=(0, 1))
        pk = {model_path!r} + ".parakeet.bin"
        write_parakeet_model(pk, hp, np.ones((16, 33), np.float32),
                             np.hanning(64).astype(np.float32),
                             [bytes([97 + i]) for i in range(8)],
                             synth_parakeet_tensors(hp))
        assert ParakeetContext.from_file(pk, device="cpu").full(pcm) == 0
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "whisper_tpu")]
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_refusals(model_path):
    # CapturedWeight is ported (imatrix capture, cli/make_imatrix.py): it
    # hands each product's input to its collector and computes as before.
    # The JAX package's native C mel is ported too (whisper_tpu_torch/
    # native.py; tests/test_torch_copies.py holds it to the JAX one's): what
    # stays refused is a backend neither package has.
    from whisper_tpu_torch.audio.mel import LogMel
    from whisper_tpu_torch.models.whisper import model as M

    seen = []

    class Rec:
        def add(self, names, x):
            seen.append((names, tuple(x.shape)))

    w = torch.randn(8, 4)
    x = torch.randn(3, 8)
    y = M._mm(x, CapturedWeight(["w"], w, Rec()), torch.float32)
    torch.testing.assert_close(y, x @ w, rtol=0, atol=0)
    assert seen == [(["w"], (3, 8))]
    mel, n_len_org = LogMel(np.ones((80, 201), np.float32), backend="native")(
        np.zeros(16000, np.float32))
    assert mel.shape == (80, 3100) and n_len_org == 99
    with pytest.raises(ValueError, match="unknown mel backend"):
        LogMel(np.ones((80, 201), np.float32), backend="jax")


def test_default_device_needs_a_card(model_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        W.load(model_path)
