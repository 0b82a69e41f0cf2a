"""The port's C ABI bridge (whisper_tpu_torch/capi.py) against the JAX
package's (whisper_tpu/capi.py), on the CPU.

Both capis get the same DECISIVE synthetic file (utils/synth.py, 3 text
layers so timestamps are on) and 12 s of seeded noise; the port's context is
made with whisper_context_params' use_gpu = false (the CPU; the default,
true, takes the CUDA card), the JAX one with its defaults.  Both compute in
f32 with dense weights there.

- `full` through the JSON params (greedy and beam 5): identical segments,
  token ids, token and segment timestamps and text; token p within 2e-6
  and no_speech_prob within 1e-5 (f32 softmaxes summed in another order).
- the step-by-step drive: pcm_to_mel gives the same n_len, set_mel takes the
  JAX mel, encode + decode give logits within 1e-4 of max |logit| (f32
  products summed in another order through 2 encoder and 3 decoder
  layers), at n_past 0 and 1; the language detection's id is equal and its
  probabilities within 1e-5; the state variants match the context's.
- the VAD surface on the synthetic Silero file (Silero's widths, seed 0),
  the port's VAD context made with use_gpu = false (its default, true,
  takes the card, unlike whisper.cpp's): probabilities within rtol 1e-5 (tests/test_torch_vad.py's bound),
  segments from probs and from samples equal, and `full` with VAD keeps
  the same speech segments.
- introspection, tokenizer, default params, the log sink, timings.
- with no card, an init whose params ask for one (the whisper, Parakeet
  and VAD defaults all do) returns 0 and logs why.
- every public function of whisper_tpu/capi.py and capi_parakeet.py exists
  in the port with the same signature.
"""

import ctypes
import inspect
import json
import struct

import numpy as np
import pytest
import torch

import whisper_tpu.capi as JC
import whisper_tpu.capi_parakeet as JCP
import whisper_tpu_torch.capi as TC
import whisper_tpu_torch.capi_parakeet as TCP
from whisper_tpu_torch.models.vad.writer import synth_vad_tensors, write_vad_model
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
CPU = json.dumps({"use_gpu": False})
GREEDY = json.dumps({"language": "en", "temperature_inc": 0.0})
BEAM = json.dumps({"strategy": 1, "language": "en", "temperature_inc": 0.0})


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("capi") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 12)).astype(np.float32)


@pytest.fixture(scope="module")
def handles(model_path):
    """(JAX handle, port handle) on one file; freed at the module's end."""
    hj = JC.init_from_file(model_path)
    ht = TC.init_from_file_with_cparams(model_path, CPU)
    assert hj > 0 and ht > 0
    assert TC._contexts[ht].device.type == "cpu"
    yield hj, ht
    JC.free(hj)
    TC.free(ht)


def _segments(capi, h):
    out = []
    for i in range(capi.full_n_segments(h)):
        toks = [(capi.full_get_token_id(h, i, j), capi.full_get_token_t0(h, i, j),
                 capi.full_get_token_t1(h, i, j))
                for j in range(capi.full_n_tokens(h, i))]
        out.append((capi.full_get_segment_t0(h, i), capi.full_get_segment_t1(h, i),
                    capi.full_get_segment_text(h, i),
                    capi.full_get_segment_speaker_turn_next(h, i), toks))
    return out


def _floats(capi, h):
    return ([capi.full_get_token_p(h, i, j) for i in range(capi.full_n_segments(h))
             for j in range(capi.full_n_tokens(h, i))],
            [capi.full_get_segment_no_speech_prob(h, i)
             for i in range(capi.full_n_segments(h))])


def _public_functions(mod):
    return {n: f for n, f in inspect.getmembers(mod, inspect.isfunction)
            if not n.startswith("_") and f.__module__ == mod.__name__}


@pytest.mark.parametrize("mods", [(JC, TC), (JCP, TCP)], ids=["capi", "capi_parakeet"])
def test_public_functions_have_the_jax_signatures(mods):
    jmod, tmod = mods
    want = _public_functions(jmod)
    assert len(want) > (100 if jmod is JC else 40)
    for name, fn in want.items():
        got = getattr(tmod, name, None)
        assert inspect.isfunction(got), name
        assert inspect.signature(got) == inspect.signature(fn), name
    if jmod is JC:      # the shim calls the Parakeet half through capi too
        assert all(getattr(TC, n) is getattr(TCP, n) for n in _public_functions(JCP))


@pytest.mark.parametrize("params", [GREEDY, BEAM], ids=["greedy", "beam"])
def test_full_matches_jax(handles, pcm, params):
    hj, ht = handles
    assert JC.full(hj, params, pcm) == 0
    assert TC.full(ht, params, pcm) == 0
    want = _segments(JC, hj)
    assert len(want) >= 2 and want[0][4]
    assert _segments(TC, ht) == want
    (pj, nj), (pt, nt) = _floats(JC, hj), _floats(TC, ht)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-5)
    assert TC.full_lang_id(ht) == JC.full_lang_id(hj)
    for i, j in ((0, 0), (1, 2)):
        a = struct.unpack("<2i4f3qf", JC.full_get_token_data_packed(hj, i, j))
        b = struct.unpack("<2i4f3qf", TC.full_get_token_data_packed(ht, i, j))
        assert a[:2] == b[:2] and a[6:9] == b[6:9]
        np.testing.assert_allclose(b[2:6], a[2:6], rtol=0, atol=2e-6)
        assert (json.loads(TC.full_get_token_data_json(ht, i, j)).keys()
                == json.loads(JC.full_get_token_data_json(hj, i, j)).keys())
        assert TC.full_get_token_text(ht, i, j) == JC.full_get_token_text(hj, i, j)


def test_lowlevel_drive_matches_jax(handles, pcm):
    hj, ht = handles
    for capi, h in ((JC, hj), (TC, ht)):
        assert capi.pcm_to_mel(h, pcm) == 0
    assert TC.n_len(ht) == JC.n_len(hj) > 0
    mel = np.asarray(JC._contexts[hj].mel, np.float32)
    np.testing.assert_allclose(TC._contexts[ht].mel, mel, rtol=0, atol=1e-5)
    # set_mel: both take the JAX mel, flattened row-major as whisper.h has it
    for capi, h in ((JC, hj), (TC, ht)):
        assert capi.set_mel(h, mel.reshape(-1), mel.shape[1], mel.shape[0]) == 0
        assert capi.set_mel(h, mel.reshape(-1), mel.shape[1], 7) == -1
        assert capi.encode(h, 0) == 0
    sot = JC.token_sot(hj)
    for n_past, toks in ((0, [sot]), (1, [sot + 1, JC.token_beg(hj)])):
        assert JC.decode(hj, toks, n_past) == 0 and TC.decode(ht, toks, n_past) == 0
        lj, lt = JC.get_logits(hj), TC.get_logits(ht)
        assert lt.shape == lj.shape == (JC.n_vocab(hj),)
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4 * np.abs(lj).max())
        assert TC.get_logits_bytes(ht) == lt.astype("<f4").tobytes()
    lid = JC.lang_auto_detect(hj, 0)
    assert TC.lang_auto_detect(ht, 0) == lid >= 0
    pj = np.frombuffer(JC.get_lang_probs_bytes(hj), "<f4")
    pt = np.frombuffer(TC.get_lang_probs_bytes(ht), "<f4")
    assert pt.shape == pj.shape == (TC.lang_max_id() + 1,)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    assert TC.encode(123456789, 0) == -1 and TC.decode(123456789, [sot], 0) == -1


def test_states_match_jax(handles, pcm):
    hj, ht = handles
    sj, st = JC.init_state(hj), TC.init_state(ht)
    assert sj > 0 and st > 0 and TC.init_state(123456789) == 0
    for capi, h, s in ((JC, hj, sj), (TC, ht, st)):
        assert capi.full_with_state(h, s, GREEDY, pcm) == 0
    seg = lambda capi, s: [
        (capi.full_get_segment_t0_from_state(s, i), capi.full_get_segment_t1_from_state(s, i),
         capi.full_get_segment_text_from_state(s, i),
         [(capi.full_get_token_id_from_state(s, i, j),
           capi.full_get_token_t0_from_state(s, i, j))
          for j in range(capi.full_n_tokens_from_state(s, i))])
        for i in range(capi.full_n_segments_from_state(s))]
    assert seg(TC, st) == seg(JC, sj) and len(seg(JC, sj)) >= 2
    assert TC.full_lang_id_from_state(st) == JC.full_lang_id_from_state(sj)
    assert (TC.full_get_token_text_from_state(ht, st, 0, 1)
            == JC.full_get_token_text_from_state(hj, sj, 0, 1))
    a = struct.unpack("<2i4f3qf", JC.full_get_token_data_packed_from_state(sj, 0, 1))
    b = struct.unpack("<2i4f3qf", TC.full_get_token_data_packed_from_state(st, 0, 1))
    assert a[:2] == b[:2] and a[6:9] == b[6:9]
    # the step-by-step variants land on the state, not on the context
    for capi, h, s in ((JC, hj, sj), (TC, ht, st)):
        capi.pcm_to_mel_with_state(h, s, pcm[:16000 * 3])
        assert capi.encode_with_state(h, s, 0) == 0
        assert capi.decode_with_state(h, s, [capi.token_sot(h)], 0) == 0
    assert TC.n_len_from_state(st) == JC.n_len_from_state(sj) > 0
    lj = np.frombuffer(JC.get_logits_bytes_from_state(sj), "<f4")
    lt = np.frombuffer(TC.get_logits_bytes_from_state(st), "<f4")
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4 * np.abs(lj).max())
    assert TC.lang_auto_detect_with_state(ht, st, 0) == JC.lang_auto_detect_with_state(hj, sj, 0)
    JC.free_state(sj)
    TC.free_state(st)
    assert TC.full_n_segments_from_state(st) == 0


def test_introspection_matches_jax(handles):
    hj, ht = handles
    names = ["n_vocab", "n_audio_ctx", "n_text_ctx", "is_multilingual", "model_n_vocab",
             "model_n_audio_ctx", "model_n_audio_state", "model_n_audio_head",
             "model_n_audio_layer", "model_n_text_ctx", "model_n_text_state",
             "model_n_text_head", "model_n_text_layer", "model_n_mels", "model_ftype",
             "model_type", "model_type_readable", "token_eot", "token_sot", "token_solm",
             "token_prev", "token_nosp", "token_not", "token_beg", "token_translate",
             "token_transcribe"]
    for name in names:
        assert getattr(TC, name)(ht) == getattr(JC, name)(hj), name
    assert TC.token_lang(ht, 3) == JC.token_lang(hj, 3)
    for text in (" and so", "hello world"):
        assert TC.tokenize(ht, text) == JC.tokenize(hj, text)
        assert TC.token_count(ht, text) == JC.token_count(hj, text)
    assert TC.token_to_str(ht, 5000) == JC.token_to_str(hj, 5000)
    for i in (0, 1, 50, TC.lang_max_id()):
        assert (TC.lang_str(i), TC.lang_str_full(i)) == (JC.lang_str(i), JC.lang_str_full(i))
    assert TC.lang_id("de") == JC.lang_id("de") and TC.lang_max_id() == JC.lang_max_id()
    for s in (0, 1):
        assert TC.full_default_params_json(s) == JC.full_default_params_json(s)
    assert TC.version() and TC.system_info().startswith("WHISPER_TPU_TORCH")
    assert "NATIVE = " in TC.system_info()
    assert "bench failed" in TC.bench_memcpy_str()   # whisper-bench needs the card


def test_timings_and_log_sink(handles, pcm, capsys):
    hj, ht = handles
    for capi, h in ((JC, hj), (TC, ht)):
        capi.reset_timings(h)
        assert capi.full(h, GREEDY, pcm) == 0
    tj = struct.unpack("<5f", JC.get_timings_packed(hj))
    tt = struct.unpack("<5f", TC.get_timings_packed(ht))
    assert all(v >= 0 for v in tt) and tt[1] > 0 and tj[1] > 0
    TC.print_timings(ht)
    TC.reset_timings(ht)
    assert struct.unpack("<5f", TC.get_timings_packed(ht)) == (0.0,) * 5
    assert TC.full(ht, GREEDY, pcm[:16000]) == 0      # the fresh timers still count
    capsys.readouterr()

    from whisper_tpu_torch.runtime.logging import log_info, log_warn

    lines = []
    cb_t = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
    cb = cb_t(lambda lvl, txt, ud: lines.append((lvl, txt, ud)))
    TC.log_set_c_sink(ctypes.cast(cb, ctypes.c_void_p).value, 7)
    try:
        log_info("log sink test\n")
        log_warn("warned\n")
    finally:
        TC.log_set_c_sink(0, 0)
    assert lines == [(2, b"log sink test\n", 7), (3, b"warned\n", 7)]
    log_info("")


def test_vad_surface_matches_jax(tmp_path, pcm, handles):
    vad = str(tmp_path / "silero-synth.bin")
    write_vad_model(vad, synth_vad_tensors(seed=0))
    clip = pcm.copy()
    clip[16000 * 4:16000 * 7] = 0.0
    vj, vt = JC.vad_init_from_file(vad), TC.vad_init_from_file_with_cparams(vad, CPU)
    assert vj > 0 and vt > 0 and TC._contexts[vt].device.type == "cpu"
    for capi, h in ((JC, vj), (TC, vt)):
        assert capi.vad_detect_speech(h, clip) == 1
    assert TC.vad_n_probs(vt) == JC.vad_n_probs(vj) > 0
    pj = np.frombuffer(JC.vad_probs_bytes(vj), "<f4")
    pt = np.frombuffer(TC.vad_probs_bytes(vt), "<f4")
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=0)
    vp = json.dumps({"threshold": float(np.median(pj)), "max_speech_duration_s": 2.0})

    def segs(capi, sh):
        assert sh > 0
        out = [(capi.vad_segments_get_segment_t0(sh, i), capi.vad_segments_get_segment_t1(sh, i))
               for i in range(capi.vad_segments_n_segments(sh))]
        capi.vad_free_segments(sh)
        return out

    want = segs(JC, JC.vad_segments_from_probs(vj, vp))
    assert len(want) >= 2
    assert segs(TC, TC.vad_segments_from_probs(vt, vp)) == want
    assert (segs(TC, TC.vad_segments_from_samples(vt, vp, clip))
            == segs(JC, JC.vad_segments_from_samples(vj, vp, clip)))
    for capi, h in ((JC, vj), (TC, vt)):
        assert capi.vad_detect_speech(h, clip[:16000], reset=False) == 1
        capi.vad_reset_state(h)
    hj, ht = handles
    params = json.dumps({"language": "en", "temperature_inc": 0.0, "vad": True,
                         "vad_model_path": vad,
                         "vad_params": json.loads(vp)})
    for capi, h in ((JC, hj), (TC, ht)):
        assert capi.full(h, params, clip) == 0
    used = lambda capi, h: [(capi.full_get_vad_segment_t0(h, i), capi.full_get_vad_segment_t1(h, i))
                            for i in range(capi.full_n_vad_segments(h))]
    assert used(TC, ht) == used(JC, hj) and used(JC, hj)
    assert _segments(TC, ht) == _segments(JC, hj)
    JC.vad_free(vj)
    TC.vad_free(vt)
    assert TC.vad_init_from_file_with_cparams(str(tmp_path / "missing.bin"), CPU) == 0
    with open(vad, "rb") as f:
        vb = TC.vad_init_from_buffer_with_cparams(f.read(), CPU)
    assert vb > 0 and TC._contexts[vb].device.type == "cpu"
    TC.vad_free(vb)


def test_init_without_a_card_returns_null(model_path, monkeypatch):
    from whisper_tpu_torch.runtime.logging import log_set

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    log_set(lambda level, text: seen.append(text))
    try:
        assert TC.init_from_file(model_path) == 0
        assert TC.init_from_file_with_cparams(model_path, json.dumps({"use_gpu": True})) == 0
        with open(model_path, "rb") as f:
            assert TC.init_from_buffer(f.read()) == 0
        assert TC.pk_init_from_file(model_path) == 0
        assert TC.vad_init_from_file_with_cparams(model_path, json.dumps({"use_gpu": True})) == 0
        assert TC.vad_init_from_file(model_path) == 0
    finally:
        log_set(None)
    assert len(seen) == 6 and all("no CUDA card" in s for s in seen), seen
    with open(model_path, "rb") as f:
        h = TC.init_from_buffer_with_cparams(f.read(), CPU)
    assert h > 0 and TC._contexts[h].device.type == "cpu"
    TC.free(h)
    assert TC.full_n_segments(h) == 0


def test_cparams_dtw(model_path, pcm):
    """whisper_context_params' DTW fields act after the device is chosen,
    and a bad custom head list fails the init, as in the JAX package."""
    cp = {"use_gpu": False, "dtw_token_timestamps": True, "dtw_aheads_preset": 1,
          "dtw_n_top": 1}
    h = TC.init_from_file_with_cparams(model_path, json.dumps(cp))
    assert h > 0 and TC._contexts[h].dtw_token_timestamps and TC._contexts[h].dtw_aheads
    assert TC.full(h, GREEDY, pcm[:16000 * 4]) == 0
    TC.free(h)
    bad = dict(cp, dtw_aheads_preset=2, dtw_aheads=[[99, 0]])
    assert TC.init_from_file_with_cparams(model_path, json.dumps(bad)) == 0
