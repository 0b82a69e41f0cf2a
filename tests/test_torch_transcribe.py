"""The slice end to end: `whisper_tpu_torch.load` + `transcribe` on the CPU
against `whisper_tpu.load` + `transcribe` on the same synthetic q5_0 file.

The file is DECISIVE (utils/synth.py make_decisive): greedy argmax margins
sit far above f32 summation-order noise, so at t=0 the two packages must
give identical segments (text, t0, t1) and token ids.  Fallback attempts
at t>0 sample on the host from the reference's mt19937 stream in both
packages; only their completion is checked here (t>0 agreement is
statistical, ROADMAP queue 3), while the t=0 attempts must still match.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

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


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_fallback_ladder_completes(model_path, pcm, kv_itype):
    # an unreachable logprob threshold fails every attempt but the last, so
    # each window runs t = 0 on the device loop and t > 0 on the host loop
    # with best_of lanes (a tiled q8 cache keeps its scales in the port)
    kw = dict(logprob_thold=1.0, temperature_inc=0.5)
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True,
                  kv_itype=kv_itype)
    j_t0, t_t0 = _record_windows(jctx), _record_windows(tctx)
    J.transcribe(jctx, J.TranscribeParams(**kw), pcm)
    got = W.transcribe(tctx, W.TranscribeParams(**kw), pcm)
    assert len(t_t0) >= 2 and len(j_t0) >= 2
    # window 2's prompt carries window 1's chosen (t > 0) tokens.  With a q8
    # cache the JAX package's host loop tiles the cache without its scales
    # (decoding/full.py _tile_cache builds a dense KVCache from the int8
    # codes), so its t > 0 attempts and everything after them differ; the
    # first window's t = 0 attempt is unaffected
    n_cmp = len(j_t0) if kv_itype == "f16" else 1
    assert t_t0[:n_cmp] == j_t0[:n_cmp]
    assert all(t == 0.0 for _, t, _ in t_t0)
    assert tctx.timings.n_fail_p >= 2          # the ladder really ran
    assert all(isinstance(s.text, str) and s.tokens for s in got)


def test_isolation_no_jax_in_process(model_path):
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import whisper_tpu_torch as W
        ctx = W.load({model_path!r}, device="cpu")
        pcm = (0.1 * np.random.default_rng(0).standard_normal(16000 * 3)).astype(np.float32)
        W.transcribe(ctx, W.TranscribeParams(temperature_inc=0.0), pcm)
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
    model = W.load_model(model_path)
    with pytest.raises(NotImplementedError):
        W.WhisperContext(model, device="cpu", precision="ggml_cpu_f16")
    ctx = W.WhisperContext(model, device="cpu")
    pcm = np.zeros(16000, np.float32)
    for kw in (dict(vad=True), dict(grammar_rules=[[]])):
        with pytest.raises(NotImplementedError):
            W.transcribe(ctx, W.TranscribeParams(**kw), pcm)
    with pytest.raises(NotImplementedError):
        ctx.enable_dtw()
    with pytest.raises(NotImplementedError):
        CapturedWeight(["w"], None, None)
    ctx.batcher = object()
    with pytest.raises(NotImplementedError):
        W.transcribe(ctx, W.TranscribeParams(temperature_inc=0.0), pcm)


def test_default_device_needs_a_card(model_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        W.load(model_path)
