"""DTW token timestamps in the port against the JAX package's, on the CPU.

`_alignment_weights_all` (one full-sequence causal decoder pass returning
every layer's cross-attention softmax) with dense weights agrees with the
JAX function to 1e-5; the port's packed pass, whose six matmuls per layer
run the bare streaming dequant kernel's plain version (ops/qmm.py `qmmt`,
K2), agrees with the JAX dense pass to 1e-4, as tests/test_torch_model.py
allows for packed products.  `transcribe` with `enable_dtw(n_top_most=1)`
gives the JAX package's segments and `t_dtw` on the DECISIVE file, dense
and packed.  The JAX package's DTW pass reads the dense leaves that its
packed install deletes: with packed weights it raises KeyError (the
reference's behaviour, recorded here).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu_torch as W
from whisper_tpu.decoding import dtw as JD
from whisper_tpu.models.whisper import model as JM
from whisper_tpu_torch.decoding import dtw as TD
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO, WhisperHParams
from whisper_tpu_torch.ops import qmm as QM
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dtw") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    # two windows: ~35 s of seeded noise
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def _weights(model_path, pcm, packed, cross_itype="f16"):
    """Both packages' alignment weights for one encoded window and the same
    14 tokens: (the port's, JAX dense's)."""
    jctx = J.load(model_path, cross_itype=cross_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=packed,
                  cross_itype=cross_itype)
    for c in (jctx, tctx):
        c.pcm_to_mel(pcm)
        c.encode_window(0)
    v = tctx.vocab
    toks = [v.token_sot, v.lang_token(0), v.token_not,
            *range(400, 410), v.token_eot]
    want = JD._alignment_weights_all(
        jctx.params, jnp.asarray(toks, jnp.int32), jnp.arange(len(toks), dtype=jnp.int32),
        jctx.xk, jctx.xv, hp=jctx.hp, dtype=jctx.compute_dtype)
    got = TD._alignment_weights_all(
        tctx.params, torch.tensor(toks), torch.arange(len(toks)), tctx.xk, tctx.xv,
        hp=tctx.hp, dtype=tctx.compute_dtype)
    assert tuple(got.shape) == (HP.n_text_layer, HP.n_text_head, len(toks), HP.n_audio_ctx)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cross_itype", ["f16", "q8"])
def test_alignment_weights_dense_match_jax(model_path, pcm, cross_itype):
    got, want = _weights(model_path, pcm, packed=False, cross_itype=cross_itype)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_alignment_weights_packed_match_jax_dense(model_path, pcm):
    # the packed pass runs K2's plain version, 6 launches per layer
    n = QM.qmmt.launches
    got, want = _weights(model_path, pcm, packed=True)
    assert QM.qmmt.launches == n            # CPU tensors launch nothing
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_packed_pass_goes_through_qmmt(model_path, pcm, monkeypatch):
    calls = []
    inner = QM.qmmt

    def spy(x, *a, **kw):
        calls.append(tuple(x.shape))
        return inner(x, *a, **kw)

    monkeypatch.setattr(QM, "qmmt", spy)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True)
    tctx.pcm_to_mel(pcm)
    tctx.encode_window(0)
    TD._alignment_weights_all(tctx.params, torch.arange(5) + 400, torch.arange(5),
                              tctx.xk, tctx.xv, hp=tctx.hp, dtype=tctx.compute_dtype)
    # per layer: qkv, o, xq, xo, mlp0 (K = S), mlp1 (K = 4S)
    S = HP.n_text_state
    assert calls == ([(5, S)] * 5 + [(5, 4 * S)]) * HP.n_text_layer


def test_cross_attend_return_probs_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 2, 5, 16)).astype(np.float32)
    k = rng.standard_normal((2, 30, 16)).astype(np.float32)
    v = rng.standard_normal((2, 30, 16)).astype(np.float32)
    jo, jp = JM.cross_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.float32, return_probs=True)
    to, tp = TM.cross_attend(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.float32, return_probs=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    assert torch.equal(TM.cross_attend(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.float32), to)


def _t_dtw(segs):
    return [(s.t0, s.t1, s.text, [(t.id, t.t_dtw) for t in s.tokens]) for s in segs]


@pytest.mark.parametrize("packed", [False, True])
def test_transcribe_dtw_matches_jax(model_path, pcm, packed):
    jctx = J.load(model_path)
    tctx = W.load(model_path, device="cpu", use_packed_weights=packed)
    for c in (jctx, tctx):
        c.enable_dtw(n_top_most=1)
    assert tctx.dtw_aheads == jctx.dtw_aheads == [(2, 0), (2, 1)]
    ref = J.transcribe(jctx, J.TranscribeParams(temperature_inc=0.0), pcm)
    got = W.transcribe(tctx, W.TranscribeParams(temperature_inc=0.0), pcm)
    assert len(ref) >= 2 and _t_dtw(got) == _t_dtw(ref)
    stamped = [t.t_dtw for s in got for t in s.tokens if t.id < tctx.vocab.token_eot]
    assert stamped and all(t >= 0 for t in stamped)
    assert tctx.timings.n_dtw == tctx.timings.n_encode == 2
    assert tctx.timings.t_dtw_us > 0


def test_enable_dtw_presets():
    assert TD.AHEADS_PRESETS == JD.AHEADS_PRESETS
    assert LARGE_V3_TURBO.model_name == "large-v3-turbo"
    assert (TD.resolve_aheads(LARGE_V3_TURBO, "large-v3-turbo")
            == list(JD.AHEADS_PRESETS["large-v3-turbo"]))
    with pytest.raises(ValueError):
        TD.resolve_aheads(HP, "auto")           # no preset for these dims
    with pytest.raises(ValueError):
        TD.resolve_aheads(HP, custom=[(9, 0)])  # no layer 9


def test_enable_dtw_auto_resolves_the_turbo_preset():
    # the auto preset follows hp.model_name, as the JAX context's does, and
    # the reference CLI's dotted spelling resolves to the same heads
    ctx = object.__new__(W.WhisperContext)
    ctx.hp = LARGE_V3_TURBO
    ctx.vocab = type("V", (), {"is_multilingual": True})()
    ctx.enable_dtw("auto")
    assert ctx.dtw_aheads == list(JD.AHEADS_PRESETS["large-v3-turbo"])
    ctx.enable_dtw("large.v3.turbo")
    assert ctx.dtw_aheads == list(JD.AHEADS_PRESETS["large-v3-turbo"])
    assert ctx.dtw_token_timestamps


@pytest.mark.parametrize("fn", ["resolve_aheads", "median_filter_reflect",
                                "dtw_and_backtrace"])
def test_dtw_host_functions_are_copies(fn):
    assert inspect.getsource(getattr(TD, fn)) == inspect.getsource(getattr(JD, fn))


def test_jax_packed_weights_dtw_raises_keyerror(model_path, pcm):
    # the reference's behaviour: its DTW pass reads blk["qkv_w"] from the
    # stacked dense leaves, which its packed install deletes
    jctx = J.load(model_path, use_packed_weights=True)
    jctx.enable_dtw(n_top_most=1)
    with pytest.raises(KeyError, match="qkv_w"):
        J.transcribe(jctx, J.TranscribeParams(temperature_inc=0.0), pcm[:16000 * 5])
