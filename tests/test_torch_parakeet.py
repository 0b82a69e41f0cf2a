"""The port's Parakeet-TDT against the JAX package's, on the CPU.

Small synthetic models (the shapes of tests/test_parakeet.py and
tests/test_parakeet_packed.py) written from a seed with the writer both
packages share; both packages compute from the same weights (the JAX
tree through `convert.params_from_numpy`) and the same seeded audio.

Tolerances: the encoder's pieces (the conv stem, global and local rel-pos
attention, the conv module, a conformer block, the whole encoder) and the
prediction and joint networks agree to 1e-4 of the largest |value| of the
JAX result (TOL: f32 products and convolutions summed in another order);
the port's local attention equals its global attention to the same bound
where the window covers every key; packed weights (q5_0, q4_k) equal dense
ones and the JAX packed encode to the same bound.  Decoded tokens, frames
and durations are equal exactly; p to 1e-5.  The numpy mel is equal to the
JAX package's bit for bit, the torch mel within 1e-5 of max |mel| of it.
parakeet-quantize writes the JAX tool's bytes, and parakeet-cli's -otxt and
--batch text equals `python -m whisper_tpu.cli.parakeet_cli -ng`'s.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.cli import parakeet_cli as JCLI
from whisper_tpu.cli import parakeet_quantize as JPQ
from whisper_tpu.models.parakeet import mel as JMEL
from whisper_tpu.models.parakeet import model as JM
from whisper_tpu.models.parakeet.context import FullParams as JFullParams
from whisper_tpu.models.parakeet.context import ParakeetContext as JContext
from whisper_tpu_torch.audio.io import write_wav
from whisper_tpu_torch.cli import parakeet_cli as TCLI
from whisper_tpu_torch.cli import parakeet_quantize as TPQ
from whisper_tpu_torch.models.parakeet import mel as TMEL
from whisper_tpu_torch.models.parakeet import model as TM
from whisper_tpu_torch.models.parakeet.context import FullParams, ParakeetContext
from whisper_tpu_torch.models.parakeet.convert import params_from_numpy
from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
from whisper_tpu_torch.models.parakeet.load import build_param_pytree, load_parakeet_model
from whisper_tpu_torch.models.parakeet.writer import (synth_parakeet_tensors,
                                                      write_parakeet_model)

TOL = 1e-4
MEL_RTOL = 1e-5

SMALL = ParakeetHParams(
    n_vocab=12, n_audio_ctx=512, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_mels=32, n_fft=128, subsampling_factor=8,
    n_subsampling_channels=8, n_conv_kernel=9, n_pred_dim=32,
    n_pred_layers=2, n_tdt_durations=3, n_max_tokens=4,
    tdt_durations=(0, 1, 2))
# every quantized in-dim divisible by 256, so q4_k applies
QUANTIZABLE = ParakeetHParams(
    n_vocab=12, n_audio_ctx=512, n_audio_state=256, n_audio_head=4,
    n_audio_layer=2, n_mels=128, n_fft=512, subsampling_factor=8,
    n_subsampling_channels=16, n_conv_kernel=9, n_pred_dim=256,
    n_pred_layers=2, n_tdt_durations=3, n_max_tokens=4,
    tdt_durations=(0, 1, 2))
VOCAB = [b"<unk>", b"<s>", b"</s>", "▁a".encode(), b"b", b"c", b",",
         "▁d".encode(), b"e", b".", b"f", b"g"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, hp, seed, use_f16=False):
    rng = np.random.default_rng(seed)
    n_fb = hp.n_fft // 2 + 1
    filters = (rng.random((hp.n_mels, n_fb)) * 0.05).astype(np.float32)
    window = np.hanning(hp.n_fft).astype(np.float32)
    tensors = synth_parakeet_tensors(hp, seed=seed)
    # varied output: without the stem's biases the frames differ (with them
    # the stem's output barely moves over time, and one token wins them all)
    for name in [f"encoder.pre_encode.conv.{i}.bias" for i in (0, 2, 3, 5, 6)] + [
            "encoder.pre_encode.out.bias"]:
        tensors[name] *= 0.0
    write_parakeet_model(str(path), hp, filters, window, VOCAB, tensors, use_f16=use_f16)
    return str(path)


@pytest.fixture(scope="module")
def small_path(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("pk") / "small.bin", SMALL, seed=0)


@pytest.fixture(scope="module")
def f16_path(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("pk16") / "q-f16.bin", QUANTIZABLE, seed=1,
                  use_f16=True)


def pcm_clip(seconds: float, seed: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            ).astype(np.float32)


def _close(ref, got, tol=TOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = np.abs(ref - got).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _trees(hp, seed=0):
    """The same seeded weights as a JAX tree and as the port's tensors."""
    tree = build_param_pytree(synth_parakeet_tensors(hp, seed=seed), hp)
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree)


def _layer(jtree, ttree, il=0):
    return (jax.tree_util.tree_map(lambda a: a[il], jtree["layers"]),
            TM.layer_params(ttree["layers"], il))


def _x(T, S, seed=1):
    return np.random.default_rng(seed).standard_normal((T, S)).astype(np.float32)


# ---------------------------------------------------------------------------
# the encoder's pieces and the prediction/joint networks
# ---------------------------------------------------------------------------

def test_pre_encode():
    jt, tt = _trees(SMALL)
    mel = _x(203, SMALL.n_mels)
    ref = JM.pre_encode(jt["pre"], jnp.asarray(mel), SMALL)
    got = TM.pre_encode(tt["pre"], torch.from_numpy(mel)[None], SMALL)[0]
    _close(ref, got, what="pre_encode")


@pytest.mark.parametrize("T,n_valid", [(40, 40), (57, 45)])
def test_rel_attention_global(T, n_valid):
    jt, tt = _trees(SMALL)
    jl, tl = _layer(jt, tt, 1)
    x = _x(T, SMALL.n_audio_state)
    mask = np.where(np.arange(T) < n_valid, 0.0, JM.MASK_VALUE).astype(np.float32)
    ref = JM._rel_attention_global(jnp.asarray(x), jl, SMALL.n_audio_head,
                                   jnp.asarray(mask), jnp.float32)
    got = TM._rel_attention_global(torch.from_numpy(x)[None], tl, SMALL.n_audio_head,
                                   torch.from_numpy(mask)[None])[0]
    _close(ref, got, what="global attention")


@pytest.mark.parametrize("T,n_valid", [(700, 650), (300, 300)])
def test_rel_attention_local(T, n_valid):
    jt, tt = _trees(SMALL)
    jl, tl = _layer(jt, tt)
    x = _x(T, SMALL.n_audio_state, seed=2)
    valid = np.arange(T) < n_valid
    ref = JM._rel_attention_local(jnp.asarray(x), jl, SMALL.n_audio_head,
                                  jnp.asarray(valid), jnp.float32)
    got = TM._rel_attention_local(torch.from_numpy(x)[None], tl, SMALL.n_audio_head,
                                  torch.from_numpy(valid)[None])[0]
    _close(ref, got, what="local attention")


@pytest.mark.parametrize("T", [96, 129])
def test_local_attention_matches_global(T):
    """T <= W+1: every key lies inside each query's +-W window, so the
    banded path equals full attention (tests/test_parakeet.py:140, in the
    port)."""
    _, tt = _trees(SMALL)
    tl = TM.layer_params(tt["layers"], 0)
    x = torch.from_numpy(_x(T, SMALL.n_audio_state, seed=3))[None]
    g = TM._rel_attention_global(x, tl, SMALL.n_audio_head, torch.zeros(1, T))
    loc = TM._rel_attention_local(x, tl, SMALL.n_audio_head, torch.ones(1, T, dtype=torch.bool))
    _close(g[0].numpy(), loc[0], what="local == global")


def test_conv_module():
    jt, tt = _trees(SMALL)
    jl, tl = _layer(jt, tt)
    rng = np.random.default_rng(4)
    # batch-norm statistics away from (0, 1), so its no-eps form is exercised
    mean = rng.standard_normal(SMALL.n_audio_state).astype(np.float32)
    var = (0.5 + rng.random(SMALL.n_audio_state)).astype(np.float32)
    jl = dict(jl, conv_bn_mean=jnp.asarray(mean), conv_bn_var=jnp.asarray(var))
    tl = dict(tl, conv_bn_mean=torch.from_numpy(mean), conv_bn_var=torch.from_numpy(var))
    x = _x(50, SMALL.n_audio_state)
    ref = JM._conv_module(jnp.asarray(x), jl, SMALL, jnp.float32)
    got = TM._conv_module(torch.from_numpy(x)[None], tl, SMALL)[0]
    _close(ref, got, what="conv module")


@pytest.mark.parametrize("local", [False, True])
def test_conformer_block(local):
    jt, tt = _trees(SMALL)
    jl, tl = _layer(jt, tt, 1)
    T = 300 if local else 60
    x = _x(T, SMALL.n_audio_state, seed=5)
    valid = np.arange(T) < T - 7
    if local:
        jm, tm = jnp.asarray(valid), torch.from_numpy(valid)[None]
    else:
        m = np.where(valid, 0.0, JM.MASK_VALUE).astype(np.float32)
        jm, tm = jnp.asarray(m), torch.from_numpy(m)[None]
    ref = JM.conformer_block(jnp.asarray(x), jl, SMALL, jm, local, jnp.float32)
    got = TM.conformer_block(torch.from_numpy(x)[None], tl, SMALL, tm, local)[0]
    _close(ref, got, what="conformer block")


@pytest.mark.parametrize("local", [False, True])
def test_encode(local, monkeypatch):
    """The whole encoder with a key mask (n_len_org short of the mel); the
    local case lowers the threshold in both packages to this length."""
    if local:
        monkeypatch.setattr(JM, "LOCAL_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(TM, "LOCAL_ATTN_THRESHOLD", 16)
    jt, tt = _trees(SMALL)
    mel = _x(301, SMALL.n_mels, seed=6)
    ref = JM.encode(jt, jnp.asarray(mel), 280, SMALL)
    got = TM.encode(tt, torch.from_numpy(mel)[None], 280, SMALL)[0]
    _close(ref, got, what="encode")


def test_lstm_predict_and_joint():
    jt, tt = _trees(SMALL)
    rng = np.random.default_rng(7)
    L, D = SMALL.n_pred_layers, SMALL.n_pred_dim
    h, c = (rng.standard_normal((L, D)).astype(np.float32) for _ in range(2))
    for token in (3, SMALL.blank_id):
        ref = JM.lstm_predict(jt["pred"], jt["joint"], jnp.int32(token), jnp.asarray(h),
                              jnp.asarray(c), SMALL)
        got = TM.lstm_predict(tt["pred"], tt["joint"], torch.tensor([token]),
                              torch.from_numpy(h)[None], torch.from_numpy(c)[None], SMALL)
        for r, g, what in zip(ref, got, ("pred_out", "h", "c")):
            _close(r, g[0], what=what)
    enc_t = rng.standard_normal(SMALL.n_audio_state).astype(np.float32)
    pred_out = np.array(ref[0])
    jl = JM.joint_logits(jt["joint"], jnp.asarray(enc_t), jnp.asarray(pred_out))
    tl = TM.joint_logits(tt["joint"], torch.from_numpy(enc_t)[None],
                         torch.from_numpy(pred_out)[None])[0]
    assert tl.shape == (SMALL.n_joint_out,)
    _close(jl, tl, what="joint")


# ---------------------------------------------------------------------------
# the mel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seconds", [3.0, 2.137, 0.01])
def test_mel(seconds, small_path):
    m = load_parakeet_model(small_path)
    pcm = pcm_clip(seconds, 8)
    if seconds == 2.137:
        pcm += np.sin(np.arange(len(pcm)) * 0.05).astype(np.float32)
    ref = JMEL.log_mel_spectrogram(pcm, m.filters, m.window, SMALL.n_fft)
    np.testing.assert_array_equal(
        TMEL.log_mel_spectrogram(pcm, m.filters, m.window, SMALL.n_fft), ref)
    got = TMEL.log_mel_spectrogram_torch(pcm, torch.from_numpy(m.filters),
                                         torch.from_numpy(m.window), SMALL.n_fft)
    _close(ref, got, MEL_RTOL, "torch mel")


# ---------------------------------------------------------------------------
# contexts: full, chunk, full_batch, logits, forks, callbacks
# ---------------------------------------------------------------------------

def _tokens(ctx):
    return [(d.id, d.frame_index, d.duration_idx, d.duration_value, d.t0, d.t1,
             d.is_word_start) for d in ctx.decoded_token_data]


def _seg_tokens(segs):
    return [[(d.id, d.frame_index, d.duration_value, d.t0, d.t1) for d in s.tokens]
            for s in segs]


@pytest.fixture(scope="module")
def pair(small_path):
    return JContext.from_file(small_path), ParakeetContext.from_file(small_path, device="cpu")


def test_default_device_needs_a_card(small_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ParakeetContext.from_file(small_path)


def test_full_and_chunk_match_jax(pair):
    j, t = pair
    assert t.mel_backend == "numpy" and not t.use_packed_weights
    pcm = pcm_clip(4.0, 9)
    half = len(pcm) // 2
    for ctx in (j, t):
        assert ctx.full(pcm[:half]) == 0
    assert t.full_text() == j.full_text() and _tokens(t) == _tokens(j)
    n1 = len(t.decoded_tokens)
    assert n1 > 3 and len(set(t.decoded_tokens)) > 1
    np.testing.assert_allclose([d.p for d in t.decoded_token_data],
                               [d.p for d in j.decoded_token_data], atol=1e-5)
    for ctx in (j, t):      # the LSTM state carries into the second chunk
        assert ctx.chunk(pcm[half:]) == 0
    assert _tokens(t) == _tokens(j) and len(t.decoded_tokens) > n1
    assert [s.text for s in t.result_all] == [s.text for s in j.result_all]
    assert _seg_tokens(t.result_all) == _seg_tokens(j.result_all)
    assert "decode loop" in t.print_timings()


def test_full_batch_matches_jax_and_sequential(pair, small_path):
    j, t = pair
    utts = [pcm_clip(4.0, 10), pcm_clip(2.5, 11), pcm_clip(1.3, 12)]
    state = (list(t.decoded_tokens), t.decoder.h.clone())
    rj, rt = j.full_batch(utts), t.full_batch(utts)
    assert [[s.text for s in r] for r in rt] == [[s.text for s in r] for r in rj]
    assert [_seg_tokens(r) for r in rt] == [_seg_tokens(r) for r in rj]
    # the context's own decode state is untouched
    assert t.decoded_tokens == state[0] and torch.equal(t.decoder.h, state[1])
    # sequential chunk() at the batch's padded mel shape, in each package
    mels = [TMEL.log_mel_spectrogram(s, t.model.filters, t.model.window, SMALL.n_fft)
            for s in utts]
    bucket = max(64, 1 << (max(m.shape[0] for m in mels) - 1).bit_length())
    for seq, res in ((JContext.from_file(small_path), rj),
                     (ParakeetContext.from_file(small_path, device="cpu"), rt)):
        for m, segs in zip(mels, res):
            seq.reset_state()
            seq.result_all.clear()
            seq.set_mel(np.pad(m, ((0, bucket - m.shape[0]), (0, 0))))
            seq.n_len_org = m.shape[0]
            assert seq.chunk(None) == 0
            assert seq.full_text() == "".join(s.text for s in segs)
            assert _seg_tokens(seq.result_all) == _seg_tokens(segs)
    assert t.full_batch([]) == []


def test_exact_shapes_false_full_equals_batch_of_one(small_path):
    t = ParakeetContext.from_file(small_path, device="cpu", exact_shapes=False)
    pcm = pcm_clip(3.0, 13)
    t.full(pcm)
    batch = t.full_batch([pcm])[0]
    assert _seg_tokens(t.result_all) == _seg_tokens(batch)


def test_capture_logits_and_fork_state(pair):
    j, t = pair
    pcm = pcm_clip(3.0, 14)
    for ctx in (j, t):
        ctx.capture_logits = True
        ctx.full(pcm)
        ctx.capture_logits = False
    assert t.last_logits.shape == (len(t.decoded_tokens), SMALL.n_joint_out)
    _close(j.last_logits, t.last_logits, 1e-5, "captured logits")
    before = _tokens(t)
    fork = t.fork_state()
    assert fork.params is t.params and fork.decoder.loop is t.decoder.loop
    assert fork.mel is None and fork.decoded_tokens == []
    fork.full(pcm)
    assert _tokens(fork) == before and _tokens(t) == before


def test_callbacks_and_return_codes(pair):
    j, t = pair
    pcm = pcm_clip(2.0, 15)
    for ctx, Params in ((j, JFullParams), (t, FullParams)):
        assert ctx.full(pcm, Params(encoder_begin_callback=lambda c: False)) == -6
        assert ctx.full(pcm, Params(abort_callback=lambda: True)) == -6
        calls = []
        assert ctx.full(pcm, Params(abort_callback=lambda: calls.append(1) or len(calls) > 1)) == -7
    seen = {}
    for ctx, Params in ((j, JFullParams), (t, FullParams)):
        toks, segs, prog = [], [], []
        assert ctx.full(pcm, Params(
            new_token_callback=lambda c, td: toks.append(td.id),
            new_segment_callback=lambda c, s: segs.append(s.text),
            progress_callback=lambda c, p: prog.append(p))) == 0
        seen[ctx is t] = (toks, segs, prog)
    assert seen[True] == seen[False] and seen[True][0]


# ---------------------------------------------------------------------------
# quantized files: parakeet-quantize, packed weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qtype", ["q5_0", "q4_k"])
def test_quantize_and_packed(qtype, f16_path, tmp_path):
    qj, qt = tmp_path / "jax.bin", tmp_path / "port.bin"
    assert JPQ.main([f16_path, str(qj), qtype, "-q"]) == 0
    assert TPQ.main([f16_path, str(qt), qtype, "-q"]) == 0
    assert filecmp.cmp(qj, qt, shallow=False)

    pcm = pcm_clip(3.0, 16)
    jctx = JContext.from_file(str(qt), use_packed_weights=True)
    jctx.pcm_to_mel(pcm)
    jenc = np.asarray(jctx._encode_jit(jctx.params, jnp.asarray(jctx.mel), jctx.n_len_org,
                                       hp=jctx.hp, dtype=jnp.float32))
    jctx.full(pcm)
    encs, texts = {}, {}
    for packed in (False, True):
        ctx = ParakeetContext.from_file(str(qt), device="cpu", use_packed_weights=packed)
        assert ctx.use_packed_weights == packed
        if packed:
            assert isinstance(ctx.params["layers"]["ff1_lin1_w"], TM.PQW)
            assert isinstance(ctx.params["pre"]["out_w"], TM.PQW)
            assert (ctx.params["layers"]["ff1_lin1_w"].mins is not None) == (qtype == "q4_k")
        ctx.pcm_to_mel(pcm)
        encs[packed] = ctx._encode(ctx.mel[None], ctx.n_len_org)[0]
        ctx.full(pcm)
        texts[packed] = (ctx.full_text(), _tokens(ctx))
    _close(encs[False].numpy(), encs[True], what="packed == dense")
    _close(jenc, encs[True], what="port packed == JAX packed")
    assert texts[True] == texts[False] == (jctx.full_text(), _tokens(jctx))


# ---------------------------------------------------------------------------
# parakeet-cli
# ---------------------------------------------------------------------------

def test_cli_matches_jax(small_path, tmp_path, capsys):
    outs = {}
    for name, cli in (("jax", JCLI), ("port", TCLI)):
        d = tmp_path / name
        d.mkdir()
        wavs = []
        for i, secs in enumerate((3.0, 1.7)):
            wavs.append(str(d / f"a{i}.wav"))
            write_wav(wavs[-1], pcm_clip(secs, 20 + i))
        assert cli.main(["-m", small_path, "-f", wavs[0], "-otxt", "-of",
                         str(d / "single"), "-ng", "-np"]) == 0
        single = capsys.readouterr().out
        assert cli.main(["-m", small_path, "--batch", "-otxt", "-ng", "-np", *wavs]) == 0
        batch = capsys.readouterr().out
        outs[name] = (single, batch, *((d / f).read_bytes() for f in (
            "single.txt", "a0.wav.txt", "a1.wav.txt")))
    assert outs["port"] == outs["jax"]
    assert outs["port"][2].strip()


def test_header_only_model_matches_jax():
    """A file with no tensors (the reference's empty test model): the full
    pipeline is a no-op with the JAX context's return codes."""
    from whisper_tpu.models.parakeet.load import ParakeetModel as JModel
    from whisper_tpu.models.parakeet.load import ParakeetVocab as JVocab
    from whisper_tpu_torch.models.parakeet.load import ParakeetModel, ParakeetVocab

    filters = np.ones((SMALL.n_mels, SMALL.n_fft // 2 + 1), np.float32)
    window = np.hanning(SMALL.n_fft).astype(np.float32)
    pcm = pcm_clip(1.0, 17)
    out = []
    for ctx in (JContext(JModel(SMALL, filters, window, JVocab(["a", "[BLANK]"], 1, 0, 0, 0), {})),
                ParakeetContext(ParakeetModel(SMALL, filters, window,
                                              ParakeetVocab(["a", "[BLANK]"], 1, 0, 0, 0), {}),
                                device="cpu")):
        out.append((ctx.full(pcm), ctx.n_len(), ctx.full_batch([pcm]), ctx.encode_only(),
                    ctx.full_text()))
    assert out[0] == out[1] == (0, out[0][1], [[]], -1, "")
