"""K6 (the encoder's flash route) and the encoder's attention routing,
against the JAX package.

The JAX reference of K6 is JAX's library Pallas flash_attention, run on
the CPU inside `pltpu.force_tpu_interpret_mode()`.  Only real rows (below
`true_len`) are compared: the JAX wrapper pads T to a multiple of 512 with
zeros that fall in the pad rows' segment, while the port pads nothing, so
the junk rows may differ.  Tolerance 2e-2 absolute: both outputs are bf16
(|out| stays near 1 here), and the library rounds p (or p / l) to bf16 at
another point of its online softmax than the port's single pass.

The encoder's three routes (K4 over the fused QKV buffer, K6 flash, the
plain graph) are each held to JAX `encode` in bf16 to 5e-2 of max |value|,
as test_torch_model.py holds K4: two blocks of bf16 rounding noise summed
in another order.  The routing table checks that the port picks K4, K6 or
the plain graph exactly where the JAX package's `_encoder_block` does.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import whisper_tpu.ops.attention as JA
import whisper_tpu.ops.enc_attn as JEA
from whisper_tpu.models.whisper import model as JM
from whisper_tpu.models.whisper.load import load_model as j_load
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.convert import params_from_numpy
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.ops import attention as TA
from whisper_tpu_torch.ops import decode_attn as TDA
from whisper_tpu_torch.ops import enc_attn as TEA
from whisper_tpu_torch.utils import flash_emulation as FE
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=300, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=2, n_mels=80)


@pytest.fixture
def flash_flags():
    """Restore both packages' flash switches after a test."""
    yield
    JA.set_flash_enabled(True)
    TA.set_flash_enabled(True)


# ragged lengths against the port's query blocks (128 rows at D >= 64, 64
# at D <= 32) and 64-key tiles; true_len 1 leaves one real row; heads of 32
# and 16 are the parity matrix's minis
@pytest.mark.parametrize("H,T,true_len,D", [(2, 700, 650, 64), (1, 512, 512, 128),
                                            (3, 300, 280, 64), (1, 129, 1, 64),
                                            (2, 577, 513, 64), (2, 300, 280, 32),
                                            (3, 129, 100, 16), (6, 700, 650, 16)])
def test_flash_plain_matches_library_kernel(H, T, true_len, D):
    rng = np.random.default_rng(H * T + D)
    q, k, v = (rng.standard_normal((H, T, D)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JA.flash_self_attention(
            *(jnp.asarray(a) for a in (q, k, v)), true_len=true_len))
    before = TA.flash_self_attention.launches
    out = TA.flash_self_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  true_len=true_len)
    assert TA.flash_self_attention.launches == before       # CPU: plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (H, T, D)
    np.testing.assert_allclose(out.numpy()[:, :true_len], ref[:, :true_len],
                               rtol=0, atol=2e-2)
    # values are bf16-rounded, and every row (junk rows too) is finite
    assert torch.equal(out, out.to(torch.bfloat16).float())
    assert torch.isfinite(out).all()


def test_flash_plain_reads_strided_head_views():
    T, H, D = 320, 2, 64
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (T, 3 * H * D)).astype(np.float32))
    views = [TM._split_heads(qkv[:, i * H * D:(i + 1) * H * D], H) for i in range(3)]
    dense = [v.contiguous() for v in views]
    assert torch.equal(TA.flash_self_attention(*views, true_len=300),
                       TA.flash_self_attention(*dense, true_len=300))


def test_use_flash_rule(flash_flags):
    assert TA.use_flash(256, torch.bfloat16)
    assert not TA.use_flash(255, torch.bfloat16)
    assert not TA.use_flash(1500, torch.float32)
    TA.set_flash_enabled(False)
    assert not TA.use_flash(1500, torch.bfloat16)
    assert TA._round_up(1500, 512) == JA._round_up(1500, 512) == 1536


@pytest.mark.parametrize("mode,kernel", [("auto", True), ("pallas", True),
                                         ("xla", False), ("flash", False)])
def test_enc_attn_use_kernel_env(monkeypatch, mode, kernel):
    monkeypatch.setenv("WTPU_ENC_ATTN", mode)
    assert TEA.use_kernel() is kernel
    if mode != "auto":       # the JAX package's auto means one real TPU
        assert JEA.use_kernel() is kernel


@pytest.mark.parametrize("mode,kernel", [("auto", True), ("pallas", True),
                                         ("xla", False)])
def test_decode_attn_use_kernel_env(monkeypatch, mode, kernel):
    from whisper_tpu.ops import decode_attn as JDA

    monkeypatch.setenv("WTPU_DECODE_ATTN", mode)
    assert TDA.use_kernel() is kernel
    if mode != "auto":
        assert JDA.use_kernel() is kernel


def _jax_route(monkeypatch, dtype, t_pad, n_head, d_head):
    """Which attention graph the JAX package's `_encoder_block` calls, with
    every product stubbed out (zeros) and jax.default_backend() reading
    "tpu", so use_flash applies its rule as on the TPU."""
    seen = []
    S = n_head * d_head

    def rec(name, shape_of):
        def f(*a, **kw):
            seen.append(name)
            return jnp.zeros(shape_of(*a))
        return f

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JEA, "self_attention_qkv",
                        rec("qkv", lambda qkv, *_: (qkv.shape[0], S)))
    monkeypatch.setattr(JA, "flash_self_attention", rec("flash", lambda q, *_: q.shape))
    monkeypatch.setattr(JM, "attention", rec("plain", lambda q, *_: q.shape))
    monkeypatch.setattr(JM, "_mm", lambda x, w, dt: jnp.zeros(x.shape[:-1] + (w.shape[-1],)))
    monkeypatch.setattr(JM, "layer_norm", lambda x, *a, **k: x)
    blk = {"attn_ln_w": None, "attn_ln_b": None, "qkv_w": jnp.zeros((S, 3 * S)),
           "qkv_b": jnp.zeros(3 * S), "o_w": jnp.zeros((S, S)), "o_b": jnp.zeros(S),
           "mlp_ln_w": None, "mlp_ln_b": None, "mlp0_w": jnp.zeros((S, 4)),
           "mlp0_b": jnp.zeros(4), "mlp1_w": jnp.zeros((4, S)), "mlp1_b": jnp.zeros(S)}
    JM._encoder_block(jnp.zeros((t_pad, S)), blk, n_head, 1e-5, dtype,
                      true_len=None)
    assert len(seen) == 1
    return seen[0]


ROUTE_CASES = list(itertools.product(
    ["pallas", "xla", "flash"], [True, False], ["bf16", "f32"],
    [200, 1500, 1536], [(2, 64), (3, 64), (1, 128), (4, 32)]))


@pytest.mark.parametrize("mode,flash_on", sorted({(c[0], c[1]) for c in ROUTE_CASES}))
def test_encoder_routing_table_matches_jax(monkeypatch, flash_flags, mode, flash_on):
    monkeypatch.setenv("WTPU_ENC_ATTN", mode)
    JA.set_flash_enabled(flash_on)
    TA.set_flash_enabled(flash_on)
    for _, _, dt, t_pad, (n_head, d_head) in (c for c in ROUTE_CASES
                                             if c[:2] == (mode, flash_on)):
        with monkeypatch.context() as m:
            want = _jax_route(m, jnp.bfloat16 if dt == "bf16" else jnp.float32,
                              t_pad, n_head, d_head)
        got = TM._enc_attn_route(torch.bfloat16 if dt == "bf16" else torch.float32,
                                 t_pad, n_head, d_head)
        assert got == want, (mode, flash_on, dt, t_pad, n_head, d_head)


def test_encoder_routing_auto_is_the_kernel(monkeypatch):
    # one card, no mesh: `auto` takes K4 wherever its shape rules allow
    monkeypatch.setenv("WTPU_ENC_ATTN", "auto")
    assert TM._enc_attn_route(torch.bfloat16, 1536, 20, 64) == "qkv"
    assert TM._enc_attn_route(torch.bfloat16, 1536, 3, 64) == "flash"
    assert TM._enc_attn_route(torch.float32, 1536, 20, 64) == "plain"


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "m.bin"
    write_synth_model(str(path), HP, seed=5, qtype="q5_0")
    return j_load(str(path))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal(
        (HP.n_mels, 2 * HP.n_audio_ctx)).astype(np.float32)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _count_routes(monkeypatch):
    calls = {"qkv": 0, "flash": 0, "plain": 0}
    for name, mod, attr in (("qkv", TEA, "self_attention_qkv"),
                            ("flash", TA, "flash_self_attention"),
                            ("plain", TM, "attention")):
        inner = getattr(mod, attr)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)
    return calls


def test_encode_flash_route_matches_jax(model, mel, monkeypatch):
    monkeypatch.setenv("WTPU_ENC_ATTN", "flash")
    monkeypatch.setattr(JA, "use_flash", lambda t, dtype=None: True)
    jp = jax.tree.map(jnp.asarray, model.params)
    # one jitted computation, waited for: eager ops dispatched while the
    # interpreted kernel's callbacks run their own JAX ops can deadlock
    encode = jax.jit(lambda p, m: JM.encode(p, m, HP, dtype=jnp.bfloat16, pad_to=512))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(encode(jp, jnp.asarray(mel)))
    calls = _count_routes(monkeypatch)
    out = TM.encode(params_from_numpy(model.params), torch.from_numpy(mel), HP,
                    dtype=torch.bfloat16, pad_to=512)
    assert calls == {"qkv": 0, "flash": HP.n_audio_layer, "plain": 0}
    _close(out, ref, 5e-2)


def test_encode_plain_route_matches_jax(model, mel, monkeypatch, flash_flags):
    # -nfa: flash off, WTPU_ENC_ATTN=xla: no padding, the plain graph
    monkeypatch.setenv("WTPU_ENC_ATTN", "xla")
    JA.set_flash_enabled(False)
    TA.set_flash_enabled(False)
    jp = jax.tree.map(jnp.asarray, model.params)
    ref = JM.encode(jp, jnp.asarray(mel), HP, dtype=jnp.bfloat16)
    calls = _count_routes(monkeypatch)
    out = TM.encode(params_from_numpy(model.params), torch.from_numpy(mel), HP,
                    dtype=torch.bfloat16)
    assert calls == {"qkv": 0, "flash": 0, "plain": HP.n_audio_layer}
    _close(out, ref, 5e-2)


def test_encode_pads_only_on_the_flash_route(model, mel, monkeypatch, flash_flags):
    # n_ctx = 300 >= 256 in bf16: padded to 512 with flash on, unpadded
    # with it off (the JAX package's use_flash gate on padded residency)
    seen = []
    inner = TM._encoder_block

    def spy(x, *a, **kw):
        seen.append((x.shape[0], kw.get("true_len")))
        return inner(x, *a, **kw)

    monkeypatch.setattr(TM, "_encoder_block", spy)
    monkeypatch.setenv("WTPU_ENC_ATTN", "xla")
    tp = params_from_numpy(model.params)
    hp = dataclasses.replace(HP, n_audio_layer=1)
    for flash_on, dtype, want in ((True, torch.bfloat16, (512, 300)),
                                  (False, torch.bfloat16, (300, None)),
                                  (True, torch.float32, (300, None))):
        TA.set_flash_enabled(flash_on)
        seen.clear()
        TM.encode(tp, torch.from_numpy(mel), hp, dtype=dtype)
        assert seen == [want], (flash_on, dtype)


# utils/flash_emulation.py walks the kernel's tiles in plain PyTorch: each
# of its designs computes the plain version's function within one bf16
# step of the largest real output (chip_smoke.FLASH_REL_TOL, as the card
# tests hold the kernel), and every row, junk rows too, stays finite
@pytest.mark.parametrize("mode", sorted(FE.MODES))
@pytest.mark.parametrize("H,T,true_len,D", [(2, 300, 280, 32), (3, 129, 100, 16)])
def test_flash_emulation_matches_plain(mode, H, T, true_len, D):
    g = torch.Generator().manual_seed(H * T + D)
    q, k, v = (torch.randn((H, T, D), generator=g) for _ in range(3))
    ref = TA.flash_self_attention_plain(q, k, v, true_len=true_len)
    out = FE.emulate(q, k, v, true_len=true_len, **FE.MODES[mode])
    assert torch.isfinite(out).all()
    err = (out[:, :true_len] - ref[:, :true_len]).abs().max()
    assert err <= 8e-3 * ref[:, :true_len].abs().max()
