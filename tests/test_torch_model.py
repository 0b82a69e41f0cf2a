"""The port's Whisper model functions against the JAX package's, on the
same parameters (a synthetic q5_0 file loaded once, carried over with
convert.params_from_numpy).

f32 (the CPU's compute type): encoder, cross K/V and decoder logits agree
to 1e-4 of their max |value| — the same f32 formulas in another summation
order (the port's packed matmuls sum per quant block, the JAX CPU path
dequantizes first; int8 cache rows quantize identically so only the final
products differ).  The bf16 padded encoder (kernel K4's plain version
against the Pallas kernel in interpret mode) is held to 5e-2: every
product rounds to bf16 on both sides, and two blocks of bf16 rounding
noise accumulate in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import model as JM
from whisper_tpu.models.whisper.load import load_model as j_load
from whisper_tpu.runtime.context import WhisperContext as JCtx
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.convert import params_from_numpy
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.runtime.context import WhisperContext as TCtx
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=250, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=2, n_mels=80)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "m.bin"
    write_synth_model(str(path), HP, seed=5, qtype="q5_0")
    return j_load(str(path))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal(
        (HP.n_mels, 2 * HP.n_audio_ctx)).astype(np.float32)


@pytest.fixture(scope="module")
def encoded(model, mel):
    jp = jax.tree.map(jnp.asarray, model.params)
    enc = JM.encode(jp, jnp.asarray(mel), HP, dtype=jnp.float32)
    tp = params_from_numpy(model.params)
    return jp, tp, np.array(enc)


def test_encode_f32(encoded, mel):
    _, tp, enc_ref = encoded
    enc = TM.encode(tp, torch.from_numpy(mel), HP, dtype=torch.float32)
    close(enc, enc_ref, 1e-4)


@pytest.mark.parametrize("itype", ["f16", "q8"])
def test_compute_cross_kv(encoded, itype):
    jp, tp, enc_ref = encoded
    jk, jv = JM.compute_cross_kv(jp, jnp.asarray(enc_ref), HP,
                                 dtype=jnp.float32, itype=itype)
    tk, tv = TM.compute_cross_kv(tp, torch.from_numpy(enc_ref), HP,
                                 dtype=torch.float32, itype=itype)
    if itype == "q8":
        for j, t in ((jk, tk), (jv, tv)):
            assert isinstance(t, TM.XK8)
            close(t.scale, j.scale, 1e-5)
            # codes may differ by one step where a value sits on a rounding
            # boundary after the f32 sums differ in order
            assert np.abs(t.codes.numpy().astype(int)
                          - np.asarray(j.codes).astype(int)).max() <= 1
    else:
        close(tk, jk, 1e-5)
        close(tv, jv, 1e-5)


def test_encode_bf16_padded_kernel_path(model, mel, monkeypatch):
    monkeypatch.setenv("WTPU_ENC_ATTN", "pallas")
    jp = jax.tree.map(jnp.asarray, model.params)
    ref = JM.encode(jp, jnp.asarray(mel), HP, dtype=jnp.bfloat16, pad_to=512)
    tp = params_from_numpy(model.params)
    assert TM._enc_attn_route(torch.bfloat16, 512, HP.n_audio_head,
                              HP.n_audio_state // HP.n_audio_head) == "qkv"
    out = TM.encode(tp, torch.from_numpy(mel), HP, dtype=torch.bfloat16, pad_to=512)
    close(out, ref, 5e-2)


def _decode_pair(model, encoded, packed, kv_itype):
    """Run a 4-token prompt pass then a 1-token step through both
    packages; return [(logits_jax, logits_torch, cache_jax, cache_torch)]."""
    jp, _, enc_ref = encoded
    jctx = JCtx(model, use_packed_weights=packed, kv_itype=kv_itype)
    tctx = TCtx(model, device="cpu", use_packed_weights=packed,
                kv_itype=kv_itype)
    assert jctx.use_packed_weights == tctx.use_packed_weights == packed
    jparams = jctx.params
    tparams = tctx.params
    jk, jv = JM.compute_cross_kv(jparams, jnp.asarray(enc_ref), HP,
                                 dtype=jnp.float32)
    tk, tv = params_from_numpy(np.asarray(jk)), params_from_numpy(np.asarray(jv))
    jcache = jctx.new_cache(1)
    tcache = tctx.new_cache(1)
    v = model.vocab
    prompt = np.array([[v.token_sot, v.token_sot + 1, v.token_transcribe, 440]])
    out = []
    for toks, kv_head, actx in ((prompt, 0, 128), (np.array([[1234]]), 4, 128)):
        pos = kv_head + np.arange(toks.shape[1])[None]
        jl, jcache = JM.decode_step(jparams, jnp.asarray(toks), jnp.asarray(pos),
                                    jnp.int32(kv_head), jcache, jk, jv, HP,
                                    dtype=jnp.float32, attn_ctx=actx)
        tl, tcache = TM.decode_step(tparams, torch.from_numpy(toks),
                                    torch.from_numpy(pos), kv_head, tcache,
                                    tk, tv, HP, dtype=torch.float32,
                                    attn_ctx=actx)
        # the port updates its cache in place: keep this pass's state
        out.append((jl, tl, jcache, type(tcache)(*(a.clone() for a in tcache))))
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_decode_step(model, encoded, packed, kv_itype):
    for jl, tl, jc, tc in _decode_pair(model, encoded, packed, kv_itype):
        close(tl, jl, 1e-4)
        assert np.argmax(np.asarray(jl)[0, -1]) == int(tl[0, -1].argmax())
        if kv_itype == "q8":
            close(tc.scale, jc.scale, 1e-5)
            assert np.abs(tc.kv.numpy().astype(int)
                          - np.asarray(jc.kv).astype(int)).max() <= 1
        else:
            close(tc.kv, jc.kv, 1e-5)


def test_packed_planes_match_jax_context(model):
    jctx = JCtx(model, use_packed_weights=True)
    tctx = TCtx(model, device="cpu", use_packed_weights=True)
    ref = params_from_numpy(jax.tree.map(np.asarray, jctx.params))
    jd, td = ref["dec"], tctx.params["dec"]
    assert set(jd["blocks"]) == set(td["blocks"])
    assert len(jd["blocks_packed"]) == len(td["blocks_packed"]) == HP.n_text_layer
    for jl, tl in zip(jd["blocks_packed"], td["blocks_packed"]):
        assert jl.keys() == tl.keys() == {"qkv_w", "o_w", "xq_w", "xo_w",
                                          "mlp0_w", "mlp1_w"}
        for k in jl:
            for a, b in zip(jl[k], tl[k]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b), k
    for k in ("tok_embd", "tok_embd_t"):
        for a, b in zip(jd[k], td[k]):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), k


def test_attn_ctx_buckets_match():
    for n in (8, 32, 100, 448):
        assert TM.attn_ctx_buckets(n) == JM.attn_ctx_buckets(n)


def test_layer_norm_and_gelu_match():
    x = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    w = np.linspace(0.5, 1.5, 64, dtype=np.float32)
    b = np.linspace(-0.1, 0.1, 64, dtype=np.float32)
    close(TM.layer_norm(*map(torch.from_numpy, (x, w, b))),
          JM.layer_norm(*map(jnp.asarray, (x, w, b))), 1e-6)
    close(TM._gelu(torch.from_numpy(x)), JM._gelu(jnp.asarray(x)), 1e-6)
