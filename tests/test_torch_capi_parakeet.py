"""The Parakeet half of the port's C ABI bridge
(whisper_tpu_torch/capi_parakeet.py) against the JAX package's, on the CPU,
on tests/test_torch_parakeet.py's small synthetic Parakeet-TDT file.

The port's context takes parakeet_context_params' use_gpu = false (the CPU;
the default, true, takes the card).  pk_full and pk_chunk give the same
segments, token ids, frames, durations and timestamps; token p within 1e-5
and the joint's logit rows within 1e-4 (tests/test_torch_parakeet.py's
bounds: f32 products summed in another order); set_mel, encode, the state
handles, tokenizer, timings and the callbacks' counts agree.
"""

import ctypes
import json
import struct

import numpy as np
import pytest
import torch

import whisper_tpu.capi as JC
import whisper_tpu_torch.capi as TC
import whisper_tpu_torch.capi_parakeet as TCP
from test_torch_parakeet import SMALL, _write, pcm_clip

CPU = json.dumps({"use_gpu": False})


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def handles(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("pkcapi") / "small.bin", SMALL, seed=0)
    hj, ht = JC.pk_init_from_file(path), TC.pk_init_from_file(path, CPU)
    assert hj > 0 and ht > 0 and TCP._pk_contexts[ht].device.type == "cpu"
    assert TCP._pk_contexts[ht].context_params == {"use_gpu": False}
    yield hj, ht, path
    JC.pk_free(hj)
    TC.pk_free(ht)


def _segs(capi, h, sh=0):
    n = capi.pk_full_n_segments(h) if not sh else capi.pk_full_n_segments_from_state(sh)
    out = []
    for i in range(n):
        toks = [struct.unpack("<4i2f2q?7x", capi.pk_full_get_token_data_packed(h, sh, i, j))
                for j in range(capi.pk_full_n_tokens(h, sh, i))]
        out.append((capi.pk_full_get_segment_t0(h, sh, i), capi.pk_full_get_segment_t1(h, sh, i),
                    capi.pk_full_get_segment_text(h, sh, i),
                    [t[:4] + t[6:] for t in toks], [t[4] for t in toks],
                    [capi.pk_full_get_token_text(h, sh, i, j) for j in range(len(toks))]))
    return out


def _same(a, b):
    assert [s[:4] + s[5:] for s in a] == [s[:4] + s[5:] for s in b]
    np.testing.assert_allclose(sum((s[4] for s in a), []), sum((s[4] for s in b), []),
                               rtol=0, atol=1e-5)


def test_full_and_chunk_match_jax(handles):
    hj, ht, _ = handles
    pcm = pcm_clip(4.0, 9)
    counts = {}
    for capi, h in ((JC, hj), (TC, ht)):
        seen = counts.setdefault(capi.__name__, [0, 0])
        cb_t = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p)

        def on_segment(c, s, n, ud, seen=seen):
            seen[0] += n

        def on_progress(c, s, p, ud, seen=seen):
            seen[1] += 1

        cb_seg, cb_prog = cb_t(on_segment), cb_t(on_progress)
        cbs = json.dumps({"new_segment": ctypes.cast(cb_seg, ctypes.c_void_p).value,
                          "progress": ctypes.cast(cb_prog, ctypes.c_void_p).value})
        assert capi.pk_full(h, 0, capi.pk_full_default_params_json(0), cbs, pcm) == 0
    assert counts["whisper_tpu_torch.capi"] == counts["whisper_tpu.capi"]
    assert counts["whisper_tpu.capi"][0] >= 1
    want = _segs(JC, hj)
    assert want and want[0][3]
    _same(_segs(TC, ht), want)
    rows, cols = JC.pk_n_logits_rows(hj, 0), JC.pk_n_logits_cols(hj, 0)
    assert (TC.pk_n_logits_rows(ht, 0), TC.pk_n_logits_cols(ht, 0)) == (rows, cols)
    lj = np.frombuffer(JC.pk_get_logits_bytes(hj, 0), "<f4")
    lt = np.frombuffer(TC.pk_get_logits_bytes(ht, 0), "<f4")
    assert lj.shape == (rows * cols,) and rows > 0
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    # chunks carry the LSTM state
    half = len(pcm) // 2
    sj, st = JC.pk_init_state(hj), TC.pk_init_state(ht)
    for capi, h, s in ((JC, hj, sj), (TC, ht, st)):
        p = json.loads(capi.pk_full_default_params_json(0))
        assert capi.pk_chunk(h, s, json.dumps(p), None, pcm[:half]) == 0
        p["no_context"] = False
        assert capi.pk_chunk(h, s, json.dumps(p), None, pcm[half:]) == 0
    _same(_segs(TC, ht, st), _segs(JC, hj, sj))
    assert TC.pk_n_len_from_state(st) == JC.pk_n_len_from_state(sj) > 0
    JC.pk_free_state(sj)
    TC.pk_free_state(st)


def test_mel_encode_tokenizer_timings_match_jax(handles):
    hj, ht, path = handles
    n_mels = SMALL.n_mels
    mel = np.random.default_rng(3).standard_normal((100, n_mels)).astype(np.float32)
    for capi, h in ((JC, hj), (TC, ht)):
        assert capi.pk_set_mel(h, 0, mel.reshape(-1), 100, n_mels - 1) == -1
        assert capi.pk_set_mel(h, 0, mel.reshape(-1), 100, n_mels) == 0
        assert capi.pk_n_len(h) == 100
        assert capi.pk_encode(h, 0, 0) == 0
        assert capi.pk_pcm_to_mel(h, 0, pcm_clip(1.0, 2)) == 0
    assert TC.pk_n_len(ht) == JC.pk_n_len(hj)
    for name in ("pk_n_vocab", "pk_n_audio_ctx", "pk_model_n_audio_state",
                 "pk_model_n_audio_head", "pk_model_n_audio_layer", "pk_model_n_mels",
                 "pk_model_ftype", "pk_token_blank", "pk_token_unk", "pk_token_bos"):
        assert getattr(TC, name)(ht) == getattr(JC, name)(hj), name
    for text in ("a b", "dee f."):
        assert TC.pk_tokenize(ht, text) == JC.pk_tokenize(hj, text)
        assert TC.pk_token_count(ht, text) == JC.pk_token_count(hj, text)
    assert TC.pk_token_to_str(ht, 3) == JC.pk_token_to_str(hj, 3)
    assert TC.pk_token_to_str(ht, 99) is None
    assert TC.pk_token_to_text("▁a", True) == JC.pk_token_to_text("▁a", True)
    assert TC.pk_full_default_params_json(0) == JC.pk_full_default_params_json(0)
    t = struct.unpack("<3f", TC.pk_get_timings_packed(ht))
    assert t[0] > 0 and t[1] > 0
    TC.pk_reset_timings(ht)
    assert struct.unpack("<3f", TC.pk_get_timings_packed(ht)) == (0.0,) * 3
    TC.pk_print_timings(ht)
    assert TC.pk_system_info() == TC.system_info() and TC.pk_version()
    with open(path, "rb") as f:
        hb = TC.pk_init_from_buffer(f.read(), CPU)
    assert hb > 0 and TC.pk_n_vocab(hb) == SMALL.n_vocab
    TC.pk_free(hb)
    assert TC.pk_full_n_segments(hb) == 0 and TC.pk_init_from_file(path + ".missing", CPU) == 0
    assert TC.pk_init_from_file(path, "not json") == 0
