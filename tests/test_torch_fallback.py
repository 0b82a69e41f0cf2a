"""The temperature-fallback ladder of `transcribe` in the port against the
JAX package, on the decisive synthetic file of test_torch_transcribe.py
(its fixtures and helper are imported from there).  Kept in a file of its
own so that a worker of its own can run it.
"""

import pytest

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_transcribe import _record_windows, model_path, pcm  # noqa: F401


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
