"""Whole transcriptions in the ggml-CPU parity mode (precision=
"ggml_cpu_f16"): the port on the CPU against the JAX package on the CPU.

On DECISIVE synthetic q5_0, q8_0 and f16 files (utils/synth.py
make_decisive) and ~35 s of seeded audio (two windows), at t = 0:
  * `transcribe`, greedy and beam 5: identical segments (t0, t1, text)
    and token ids.  Both packages take the host token loop there;
  * `transcribe_parallel` with 2 chunks (-p 2): identical merged segments.
    As in the JAX package, each chunk's worker steps its windows through
    the host loop, so no window reaches the batcher;
  * the parity window decoder (decoding/device_loop.py parity=True, eager
    on the CPU) against the JAX package's `make_window_decoder(parity=
    True)`, greedy and beam 5: token ids, timestamps and flags exactly,
    each token's logprob and the cumulative ones within 5e-3 of the largest
    prompt logit.  The f16 roundings of operands whose f32 sums differ in
    order move one step's logits some 3e-4 of their largest apart (the f32
    default mode agrees to 1e-6; tests/test_torch_parity.py holds a step
    to 1e-3), a logprob moves by at most twice that, and the f16 cache rows
    carry the difference on through the window: the largest seen is 3.1e-3,
    a beam lane's token late in the window.
"""

import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu_torch as W
from whisper_tpu.decoding.parallel import transcribe_parallel as j_parallel
from whisper_tpu_torch.decoding.parallel import transcribe_parallel as t_parallel
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.runtime import batching as TB
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
PARITY = "ggml_cpu_f16"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # many small ops per step: intra-op threads wait on each other more
    # than they compute (the results do not depend on the thread count)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FILES = {}


def model_file(tmp_path_factory, qtype):
    if qtype not in _FILES:
        path = tmp_path_factory.mktemp("parity") / f"decisive-{qtype}.bin"
        write_synth_model(str(path), HP, seed=1, qtype=qtype, decisive=True)
        _FILES[qtype] = str(path)
    return _FILES[qtype]


@pytest.fixture(scope="module")
def pcm():
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def _params(pkg, strategy):
    p = (pkg.TranscribeParams.default(pkg.SamplingStrategy.BEAM_SEARCH)
         if strategy == "beam" else pkg.TranscribeParams())
    p.temperature_inc = 0.0
    return p


def _summary(segs):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
@pytest.mark.parametrize("qtype", ["q5_0", "q8_0", "f16"])
def test_transcribe_parity_matches_jax(tmp_path_factory, pcm, qtype, strategy):
    path = model_file(tmp_path_factory, qtype)
    jctx = J.load(path, precision=PARITY)
    tctx = W.load(path, device="cpu", precision=PARITY)
    ref = J.transcribe(jctx, _params(J, strategy), pcm)
    got = W.transcribe(tctx, _params(W, strategy), pcm)
    assert len(ref) >= 2 and {s.t0 // 3000 for s in ref} == {0, 1}
    assert _summary(got) == _summary(ref)
    # the host loop: one decode per step, no window decoder built
    assert tctx.timings.n_encode == 2 and not tctx._window_fns


def test_parallel_parity_matches_jax(tmp_path_factory, pcm, monkeypatch):
    rounds = []

    class Counted(TB.WindowBatcher):
        def _take_locked(self):
            rounds.append(len(self.pending))
            return super()._take_locked()

    monkeypatch.setattr(TB, "WindowBatcher", Counted)
    path = model_file(tmp_path_factory, "q5_0")
    jctx = J.load(path, precision=PARITY)
    tctx = W.load(path, device="cpu", precision=PARITY)
    ref = j_parallel(jctx, _params(J, "greedy"), pcm, 2)
    got = t_parallel(tctx, _params(W, "greedy"), pcm, 2)
    assert len(ref) >= 2
    assert _summary(got) == _summary(ref)
    assert rounds == []


FIELDS = ("tok_id", "tok_tid", "n_tok", "result_len", "seek_delta", "has_ts",
          "failed", "completed")


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_parity_window_decoder_matches_jax(tmp_path_factory, pcm, strategy):
    path = model_file(tmp_path_factory, "q5_0")
    res = {}
    for name, pkg, kw in (("jax", J, {}), ("torch", W, {"device": "cpu"})):
        ctx = pkg.load(path, precision=PARITY, **kw)
        ctx.pcm_to_mel(pcm)
        ctx.encode_window(0)
        v = ctx.vocab
        prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
        res[name] = ctx.decode_window_device(
            prompt, 5 if strategy == "beam" else 1, 0.0, 0, ctx.n_len_org,
            _params(pkg, strategy), False, rng_seed=0, strategy=strategy)
        if name == "jax":
            logits, _ = ctx.decode(np.array([prompt]), 0, ctx.new_cache(1))
            atol = 5e-3 * np.abs(logits).max()
    want, got = res["jax"], res["torch"]
    assert int(want.n_tok.max()) > 2
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("tok_plog", "sum_logprobs"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=atol, err_msg=f)
