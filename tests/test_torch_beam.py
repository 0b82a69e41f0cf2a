"""Beam search in the port against the JAX package.

`_beam_select_core` (one beam step: top-k candidates, rolling-hash dedup,
the stable (-score, parent) order, wrap-around of surplus beams) is held
to the JAX function exactly on seeded logprobs: both add the same f32
values, so parents, tokens, scores and hashes must be identical.

The beam window decoder and `transcribe(strategy=BEAM_SEARCH)` run on a
DECISIVE synthetic file (utils/synth.py make_decisive), whose argmax
margins sit far above f32 summation-order noise: tokens, timestamps and
segments must be identical, and the cumulative logprobs agree to 1e-4.
The fallback ladder runs on an f16 cache only: with a q8 cache the JAX
package's host loop tiles the cache without its scales (ROADMAP queue 3),
so its t > 0 attempts differ from the port's by design.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import whisper_tpu as J
import whisper_tpu_torch as W
from whisper_tpu.decoding import device_loop as JDL
from whisper_tpu_torch.decoding import device_loop as TDL
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
B, V, BEG = 5, 300, 200


def _state(seed, dup):
    rng = np.random.default_rng(seed)
    logprobs = np.log(rng.dirichlet(np.full(V, 0.3), B)).astype(np.float32)
    logprobs[rng.random((B, V)) < 0.2] = -np.inf
    live = np.array([True, True, False, True, True])
    sum_lp = (-5 * rng.random(B)).astype(np.float32)
    seq_hash = rng.integers(0, 2**32, (B, 2), dtype=np.uint64).astype(np.uint32)
    if dup:   # beams 0 and 1 carry the same sequence: their candidates tie
        logprobs[1], sum_lp[1], seq_hash[1] = logprobs[0], sum_lp[0], seq_hash[0]
    return logprobs, live, sum_lp, seq_hash


@pytest.mark.parametrize("step_i", [0, 3])
@pytest.mark.parametrize("seed,dup", [(0, False), (1, True), (2, True)])
def test_beam_select_core_matches_jax(step_i, seed, dup):
    logprobs, live, sum_lp, seq_hash = _state(seed, dup)
    j = JDL._beam_select_core(jnp.asarray(logprobs), jnp.asarray(live),
                              jnp.asarray(sum_lp), jnp.asarray(seq_hash),
                              jnp.int32(step_i), BEG)
    t = TDL._beam_select_core(torch.from_numpy(logprobs), torch.from_numpy(live),
                              torch.from_numpy(sum_lp),
                              torch.from_numpy(seq_hash.astype(np.int64)), step_i, BEG)
    for name, a, b in zip(("src", "tok", "score", "hash"), t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                      err_msg=name)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("beam") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    # two windows: ~35 s of seeded noise
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def _summary(segs):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]


def _beam_params(pkg, **kw):
    p = pkg.TranscribeParams.default(pkg.SamplingStrategy.BEAM_SEARCH)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_beam_window_matches_jax(model_path, pcm, kv_itype):
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True, kv_itype=kv_itype)
    res = []
    for ctx, pkg in ((jctx, J), (tctx, W)):
        ctx.pcm_to_mel(pcm)
        ctx.encode_window(0)
        v = ctx.vocab
        prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
        res.append(ctx.decode_window_device(
            prompt, B, 0.0, 0, ctx.n_len_org, _beam_params(pkg), False,
            rng_seed=0, strategy="beam"))
    jr, tr = res
    assert (tr.n_tok == jr.n_tok).all() and int(tr.n_tok.max()) > 2
    for name in ("tok_id", "tok_tid", "result_len", "seek_delta", "has_ts",
                 "failed", "completed"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name), err_msg=name)
    np.testing.assert_allclose(tr.sum_logprobs, jr.sum_logprobs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_transcribe_beam_matches_jax_at_t0(model_path, pcm, kv_itype):
    kw = dict(temperature_inc=0.0)
    ref = J.transcribe(J.load(model_path, use_packed_weights=True, kv_itype=kv_itype),
                       _beam_params(J, **kw), pcm)
    got = W.transcribe(W.load(model_path, device="cpu", use_packed_weights=True,
                              kv_itype=kv_itype), _beam_params(W, **kw), pcm)
    assert len(ref) >= 2 and {s.t0 // 3000 for s in ref} == {0, 1}
    assert _summary(got) == _summary(ref)


@pytest.mark.parametrize("kw", [
    # an unreachable logprob threshold fails every attempt but the last: the
    # t=0 beam attempt on the device loop, the t>0 attempts on the host loop
    # with best_of lanes replaying the reference's mt19937 stream (advanced
    # past the device beam attempt's skipped draws)
    dict(logprob_thold=1.0, temperature_inc=0.5),
    # the binary's t=0 beam: beam_size draws per decoder on the host loop
    dict(temperature_inc=0.0, beam_sampling="reference"),
], ids=["fallback_ladder", "reference_sampling"])
def test_transcribe_beam_host_paths_match_jax(model_path, pcm, kw):
    jctx = J.load(model_path, use_packed_weights=True)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ref = J.transcribe(jctx, _beam_params(J, **kw), pcm)
    got = W.transcribe(tctx, _beam_params(W, **kw), pcm)
    assert ref and _summary(got) == _summary(ref)
    assert tctx.timings.n_fail_p == jctx.timings.n_fail_p
