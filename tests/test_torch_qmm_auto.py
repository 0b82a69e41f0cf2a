"""The product over file-orientation planes (`QWeight`, codes (R, K)) against
the JAX package's: `ops/qmm.py` `qmm_auto`, `dequantize_qweight`,
`from_qtensor`, the model's `_mm` on a `QWeight`, and the logits head of a
decode step whose token embedding is a `QWeight` with no transposed copy.

The JAX `qmm_auto` dequantizes in the compute dtype, W = dtype(code) *
dtype(scale) (+ dtype(min)), and multiplies dtype operands with f32 sums.
At bf16 every f16-derived scale with more than 8 significant bits rounds
before the product, so a port that dequantizes in f32 and rounds once
parts from it by ~1e-3 of max |y|.  With the same rounding points only the
f32 reduction order differs: 1e-5 of max |y|.  Planes are real q5_0
(symmetric) and q4_1 (affine) quantizations of seeded weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import model as JM
from whisper_tpu.models.whisper.hparams import WhisperHParams as JHP
from whisper_tpu.ops import qmm as JQMM
from whisper_tpu.utils.synth import synth_params as j_synth_params
from whisper_tpu_torch.formats import quants as Q
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.convert import params_from_numpy
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.ops import qmm as TQMM

R, K = 64, 256
REL = 1e-5
QTYPES = pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1],
                                 ids=["q5_0", "q4_1"])


def _qtensor(qtype, r, k, seed):
    w = (0.05 * np.random.default_rng(seed).standard_normal((r, k))).astype(np.float32)
    return Q.unpack_to_planes(Q.quantize(w, qtype), qtype, (r, k))


def _port_qweight(qt):
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    return TQMM.QWeight(t(qt.codes.astype(np.int8)), t(qt.scales), t(qt.mins))


def _close(y, ref, rel=REL):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    assert y.shape == ref.shape
    err, scale = float(np.abs(y - ref).max()), float(np.abs(ref).max())
    assert err <= rel * scale, (err, scale)


def test_scales_do_not_round_exactly_in_bf16():
    """The fault's precondition: f16-derived scales lose bits in bf16."""
    qt = _qtensor(Q.GGML_TYPE_Q5_0, R, K, 1)
    s = torch.from_numpy(qt.scales)
    assert (s.to(torch.bfloat16).float() != s).float().mean() > 0.5


@QTYPES
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_mm_on_qweight_matches_jax(qtype, dtype):
    """`_mm(x, QWeight)` (-> `qmm_auto`) over two leading dims of x."""
    qt = _qtensor(qtype, R, K, 2)
    x = np.random.default_rng(3).standard_normal((2, 3, K)).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = JM._mm(jnp.asarray(x), JQMM.from_qtensor(qt), jd)
    y = TM._mm(torch.from_numpy(x), _port_qweight(qt), td)
    assert y.dtype == torch.float32 and y.shape == (2, 3, R)
    _close(y, ref)


@QTYPES
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_qmm_auto_matches_jax(qtype, dtype):
    qt = _qtensor(qtype, R, K, 2)
    x = np.random.default_rng(3).standard_normal((5, K)).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = JQMM.qmm_auto(jnp.asarray(x), JQMM.from_qtensor(qt), jd)
    _close(TQMM.qmm_auto(torch.from_numpy(x), _port_qweight(qt), td), ref)


@QTYPES
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_dequantize_qweight_matches_jax(qtype, dtype):
    qt = _qtensor(qtype, R, K, 4)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[dtype]
    ref = np.asarray(JQMM.dequantize_qweight(JQMM.from_qtensor(qt), jd).astype(jnp.float32))
    w = TQMM.dequantize_qweight(TQMM.from_qtensor(qt, device="cpu"), td)
    assert w.dtype == td and tuple(w.shape) == (R, K)
    np.testing.assert_array_equal(w.float().numpy(), ref)


@QTYPES
def test_from_qtensor_matches_jax(qtype):
    qt = _qtensor(qtype, R, K, 5)
    j = JQMM.from_qtensor(qt)
    t = TQMM.from_qtensor(qt, device="cpu")
    assert isinstance(t, TQMM.QWeight) and t.shape == (R, K)
    assert t.codes.dtype == torch.int8 and t.scales.dtype == torch.float32
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert (t.mins is None) == (j.mins is None)
    if t.mins is not None:
        np.testing.assert_array_equal(t.mins.numpy(), np.asarray(j.mins))


def test_from_qtensor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        TQMM.from_qtensor(_qtensor(Q.GGML_TYPE_Q5_0, 32, 64, 6))


HP = dict(n_vocab=96, n_audio_ctx=8, n_audio_state=32, n_audio_head=2,
          n_audio_layer=1, n_text_ctx=16, n_text_state=64, n_text_head=2,
          n_text_layer=1, n_mels=16)


@QTYPES
def test_logits_head_on_qweight_matches_jax(qtype):
    """decode_step's logits head when tok_embd is a QWeight with no
    tok_embd_t: the final layer norm, then `_mm(x, QWeight)`, at bf16."""
    hp_j, hp_t = JHP(**HP), WhisperHParams(**HP)
    params = jax.tree.map(np.asarray, j_synth_params(hp_j, jnp.float32))
    te = np.asarray(params["dec"]["tok_embd"], np.float32)
    qt = Q.unpack_to_planes(Q.quantize(te, qtype), qtype, te.shape)
    jq = JQMM.from_qtensor(qt)
    params["dec"]["tok_embd"] = jax.tree.map(np.asarray, jq)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params)
    assert isinstance(tp["dec"]["tok_embd"], TQMM.QWeight)
    rng = np.random.default_rng(7)
    d = hp_t.n_text_state // hp_t.n_text_head
    xk = rng.standard_normal((1, hp_t.n_text_head, hp_t.n_audio_ctx, d)).astype(np.float32)
    xv = 0.5 * xk
    toks = np.array([[3, 17, 40]])
    pos = np.arange(3)[None]
    jl, _ = JM.decode_step(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
                           jnp.int32(0), JM.new_cache(hp_j, 1, jnp.float32),
                           jnp.asarray(xk), jnp.asarray(xv), hp_j, dtype=jnp.bfloat16)
    tl, _ = TM.decode_step(tp, torch.from_numpy(toks), torch.from_numpy(pos), 0,
                           TM.new_cache(hp_t, 1, torch.float32), torch.from_numpy(xk),
                           torch.from_numpy(xv), hp_t, dtype=torch.bfloat16)
    _close(tl, jl)
