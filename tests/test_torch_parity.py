"""The port's ggml-CPU parity mode (precision="ggml_cpu_f16") against the
JAX package's, function by function, on the CPU.

Same seeded inputs through both packages:
  * `_mm_ggml_q` on q4_0, q5_0 and q8_0 planes, with activation rows built
    so that x / d lands on .5 (C roundf rounds those away from zero, where
    torch.round would round half to even): within 2e-6 of max |y|, the
    same exact integer block dots summed over the blocks in another order;
  * the f16 GELU table: within one f16 ulp for |x| < 3; in the saturated
    tail within one ulp plus 0.5 |x| times the two tanh's f32 error bound
    (2^-21), since 1 + tanh cancels there;
  * `encode(parity)`, `compute_cross_kv(parity)` and `decode_step(parity)`
    on q5_0 (QWGGML planes) and f16 files, with the f16 and the q8 cache:
    within 1e-3 of their max |value| (f16-rounded operands, f32 sums in
    another order);
  * `build_parity_overlay` refuses asymmetric (q4_1) and K-quant planes.
The whole transcriptions: tests/test_torch_parity_transcribe.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import model as JM
from whisper_tpu.models.whisper.load import build_parity_overlay as j_overlay
from whisper_tpu.runtime.context import WhisperContext as JCtx
from whisper_tpu_torch.formats import quants as TQ
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.models.whisper.load import build_parity_overlay as t_overlay
from whisper_tpu_torch.models.whisper.load import load_model
from whisper_tpu_torch.runtime.context import WhisperContext as TCtx
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=250, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=2, n_mels=80)
QTYPES = {"q4_0": TQ.GGML_TYPE_Q4_0, "q5_0": TQ.GGML_TYPE_Q5_0,
          "q8_0": TQ.GGML_TYPE_Q8_0}


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _planes(qtype, out_dim=96, in_dim=256, seed=0):
    w = np.random.default_rng(seed).standard_normal((out_dim, in_dim)).astype(np.float32)
    t = QTYPES[qtype]
    p = TQ.unpack_to_planes(TQ.quantize(w, t), t, w.shape)
    return p.codes.astype(np.float32), p.scales.astype(np.float32)


def _half_way_rows(in_dim=256, seed=1):
    """Rows whose Q8_0 codes sit on .5 in many places: blocks with amax 127
    (d = 1) or 63.5 (d = 0.5) whose other values are (k + 0.5) * d."""
    rng = np.random.default_rng(seed)
    rows = []
    for d in (1.0, 0.5):
        x = (rng.integers(-126, 126, in_dim) + 0.5) * d
        x[::32] = 127.0 * d * np.where(np.arange(in_dim // 32) % 2, 1, -1)
        rows.append(x)
    rows.append(rng.standard_normal(in_dim) * 3.0)
    rows.append(np.zeros(in_dim))                 # d = 0 blocks: codes 0
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("qtype", sorted(QTYPES))
def test_mm_ggml_q(qtype, monkeypatch):
    codes, scales = _planes(qtype)
    x = np.concatenate([_half_way_rows(), np.random.default_rng(2).standard_normal(
        (5, 256)).astype(np.float32)])
    want = np.asarray(JM._mm_ggml_q(jnp.asarray(x), JM.QWGGML(
        jnp.asarray(codes), jnp.asarray(scales))))
    w = TM.QWGGML(torch.from_numpy(codes), torch.from_numpy(scales))
    got = TM._mm(torch.from_numpy(x), w, torch.float16).numpy()
    close(got, want, 2e-6)
    # the half-way rows decide codes: half-to-even rounding misses them
    monkeypatch.setattr(TM, "_round_half_away", torch.round)
    even = TM._mm_ggml_q(torch.from_numpy(x), w).numpy()
    assert np.abs(even[:2] - want[:2]).max() > 1e-3 * np.abs(want).max()


def test_mm_ggml_q_chunks_rows(monkeypatch):
    # a small chunk budget splits the rows into several block-dot chunks
    codes, scales = _planes("q5_0")
    x = np.random.default_rng(3).standard_normal((2, 9, 256)).astype(np.float32)
    w = TM.QWGGML(torch.from_numpy(codes), torch.from_numpy(scales))
    whole = TM._mm_ggml_q(torch.from_numpy(x), w)
    monkeypatch.setattr(TM, "_GGML_Q_PART_BYTES", 4 * 8 * 96 * 4)
    np.testing.assert_array_equal(TM._mm_ggml_q(torch.from_numpy(x), w), whole)
    assert whole.shape == (2, 9, 96)


def test_gelu_table():
    x = np.concatenate([np.linspace(-12, 12, 48001), [-10.0, 10.0, -9.999, 9.999],
                        np.random.default_rng(4).standard_normal(4096) * 4]
                       ).astype(np.float32)
    want = np.asarray(JM._gelu(jnp.asarray(x), parity=True))
    got = TM._gelu(torch.from_numpy(x), parity=True).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    err = np.abs(got - want)
    core = np.abs(x) < 3
    assert (err[core] <= ulp[core]).all()
    # in the saturated tail 1 + tanh cancels: XLA-CPU's f32 tanh is up to
    # ~4.3 f32 ulps (2.6e-7) off there, torch's under one, and 0.5 x times
    # that error is several f16 subnormal ulps of a result near 0
    assert (err <= ulp + 0.5 * np.abs(x) * 2.0 ** -21).all()
    np.testing.assert_array_equal(got[x <= -10], 0.0)
    np.testing.assert_array_equal(got[x >= 10], x[x >= 10])


@pytest.fixture(scope="module", params=["q5_0", "f16"])
def contexts(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("par") / f"m-{request.param}.bin"
    write_synth_model(str(path), HP, seed=5, qtype=request.param)
    model = load_model(str(path))
    j = JCtx.from_file(str(path), precision="ggml_cpu_f16")
    t = TCtx(model, device="cpu", precision="ggml_cpu_f16")
    return request.param, j, t


def test_context_parity_mode(contexts):
    qtype, j, t = contexts
    assert t.parity and t.compute_dtype == torch.float16
    assert t.cache_dtype == torch.float16 and not t.use_packed_weights
    assert t.mel_fn.backend == "numpy"
    blk = t.params["enc"]["blocks"]["mlp0_w"]
    assert isinstance(blk, TM.QWGGML) == (qtype != "f16")
    assert isinstance(t.params["dec"]["tok_embd"], TM.QWGGML) == (qtype != "f16")


@pytest.fixture(scope="module")
def encoded(contexts):
    qtype, j, t = contexts
    mel = np.random.default_rng(0).standard_normal(
        (HP.n_mels, 2 * HP.n_audio_ctx)).astype(np.float32)
    want = np.array(JM.encode(j.params, jnp.asarray(mel), HP,
                                dtype=jnp.float16, parity=True))
    got = TM.encode(t.params, torch.from_numpy(mel), HP, dtype=torch.float16,
                    parity=True)
    return contexts, want, got.numpy()


def test_encode_parity(encoded):
    _, want, got = encoded
    close(got, want, 1e-3)


@pytest.fixture(scope="module")
def cross(encoded):
    (_, j, t), enc, _ = encoded
    jk, jv = JM.compute_cross_kv(j.params, jnp.asarray(enc), HP,
                                 dtype=jnp.float16, parity=True)
    tk, tv = TM.compute_cross_kv(t.params, torch.from_numpy(enc), HP,
                                 dtype=torch.float16, parity=True)
    return (jk, jv), (tk, tv)


def test_cross_kv_parity(cross):
    (jk, jv), (tk, tv) = cross
    for a, b in ((tk, jk), (tv, jv)):
        assert a.dtype == torch.float16
        close(a.float(), np.asarray(b, np.float32), 1e-3)


@pytest.mark.parametrize("itype", ["f16", "q8"])
def test_decode_step_parity(encoded, cross, itype):
    (_, j, t), _, _ = encoded
    (jk, jv), _ = cross
    tk, tv = (torch.from_numpy(np.array(a)) for a in (jk, jv))
    jc = JM.new_cache(HP, 1, jnp.float16, itype=itype)
    tc = TM.new_cache(HP, 1, torch.float16, itype=itype)
    prompt = np.array([[50257, 50362, 400, 1000, 7, 50364]], np.int64)
    for n_past, toks in ((0, prompt), (6, np.array([[1234]], np.int64))):
        pos = n_past + np.arange(toks.shape[1])[None]
        jl, jc = JM.decode_step(j.params, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jnp.int32(n_past), jc,
                                jk, jv, HP, dtype=jnp.float16, parity=True)
        tl, tc = TM.decode_step(t.params, torch.from_numpy(toks), torch.from_numpy(pos),
                                n_past, tc, tk, tv, HP, dtype=torch.float16,
                                parity=True)
        close(tl, np.asarray(jl), 1e-3)
    if itype == "f16":
        assert tc.kv.dtype == torch.float16
        close(tc.kv.float(), np.asarray(jc.kv, np.float32), 1e-3)


@pytest.mark.parametrize("qtype", ["q4_1", "q5_k"])
def test_parity_overlay_refuses_asymmetric_planes(tmp_path, qtype):
    path = tmp_path / "m.bin"
    write_synth_model(str(path), HP, seed=5,
                      qtype="q4_1" if qtype == "q4_1" else "q5_0")
    model = load_model(str(path))
    planes = dict(model.qparams)
    if qtype == "q5_k":
        # one decoder weight as K-quant planes (super-block scales and mins)
        name = "decoder.blocks.0.mlp.0.weight"
        w = np.random.default_rng(6).standard_normal((512, 256)).astype(np.float32)
        planes[name] = TQ.unpack_to_planes(TQ.quantize(w, TQ.GGML_TYPE_Q5_K),
                                           TQ.GGML_TYPE_Q5_K, w.shape)
    for build in (j_overlay, t_overlay):
        with pytest.raises(ValueError, match="symmetric"):
            build(planes, model.hparams)
    if qtype == "q4_1":
        with pytest.raises(ValueError, match="symmetric"):
            TCtx(model, device="cpu", precision="ggml_cpu_f16")
