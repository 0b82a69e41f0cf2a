"""The port's Whisper tensor parallelism (whisper_tpu_torch/parallel/,
models/whisper/model.py `tp=`, decoding/device_loop.py `tp=`) against the
JAX package on the CPU.

The ranks run in processes of their own over gloo (parallel/launch.py, one
torch thread each, tests/torch_dist_ranks.py) and import no JAX; the
reference runs here, UNSHARDED, on the JAX package: the `_forward` of
tests/test_multichip_numerics.py (n_head 8, 64 wide, 2 layers; encode,
cross-K/V, a prompt pass and 2 greedy steps) on the same numpy-seeded
parameters.  The bounds are that test's own: the encoder within 2e-5;
the logits within 1e-4 (f16 cache) and 2e-3 (q8 cache) of the largest;
argmax exact.  Meshes: tp = 2 (2 ranks), tp = 4 and dp 2 x tp 2 (4 ranks).

- the q8 cache's row scale spans every head: the sharded quantizer takes
  the max over the group, so its scales and codes are bit-equal to the
  whole row's (a rank-local amax gives other ones);
- the native window decoder (W = 4 windows, greedy) decodes the JAX
  decoder's tokens at tp = 2, on the eager loop;
- medium width (S 1024, H 16, vocab 51865) at tp = 4: the decode chain of
  test_sharded_decode_step_medium_depth within 1e-4, argmax exact, with the
  decoder cut to 4 of medium's 24 layers for the CPU's memory (4 ranks
  each draw the whole tree);
- the spec table equals the JAX one leaf for leaf; the head-aligned QKV
  split reassembles exactly; packed planes raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_multichip_numerics import _forward as j_forward
from test_multichip_numerics import _hp, _medium_hp
from torch_dist_ranks import medium_xkv, whisper_params
from whisper_tpu.decoding import device_loop as JDL
from whisper_tpu.models.whisper import model as JM
from whisper_tpu.parallel import sharding as JS
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.parallel import sharding as PS
from whisper_tpu_torch.parallel.launch import launch

RANKS = "tests/torch_dist_ranks.py:whisper_sharded"
SEED = 3
TOKENS = np.array([[3, 5, 7], [11, 13, 17]])


def _port_hp(jhp):
    return WhisperHParams(**{f: getattr(jhp, f) for f in (
        "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer", "n_mels")})


HP = _port_hp(_hp())
MEDIUM = _port_hp(_medium_hp(n_text_layer=4))


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(7).standard_normal(
        (HP.n_mels, 2 * HP.n_audio_ctx)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(mel):
    """Each rank's results: 2 ranks (tp 2, the window decoder), then 4
    ranks (dp 2 x tp 2, tp 4 and the medium chain)."""
    two = launch(RANKS, 2, (HP, SEED, mel, TOKENS, [(1, 2)], True), threads=1)
    four = launch(RANKS, 4, (HP, SEED, mel, TOKENS, [(2, 2), (1, 4)], False,
                             {"hp": MEDIUM, "seed": 5}), threads=1)
    return {(1, 2): two, (2, 2): four, (1, 4): four}


@pytest.fixture(scope="module")
def reference(mel):
    jp = jax.tree.map(jnp.asarray, whisper_params(HP, SEED))
    fwd = jax.jit(lambda p, m, t, itype: j_forward(p, m, t, HP, itype),
                  static_argnums=3)
    return {itype: jax.tree.map(np.asarray, fwd(jp, jnp.asarray(mel),
                                                jnp.asarray(TOKENS, jnp.int32), itype))
            for itype in ("f16", "q8")}


@pytest.mark.parametrize("itype", ["f16", "q8"])
@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)], ids=["tp2", "tp4", "dp2xtp2"])
def test_sharded_forward_matches_jax_unsharded(ranks, reference, mesh, itype):
    enc_ref, logits_ref = reference[itype]
    for r in ranks[mesh]:
        assert r["foreign"] == []
        got = r[(*mesh, itype)]
        np.testing.assert_allclose(got["enc"], enc_ref, rtol=2e-5, atol=2e-5)
        tol = 1e-4 if itype == "f16" else 2e-3
        err = np.abs(got["logits"] - logits_ref).max() / (np.abs(logits_ref).max() + 1e-9)
        assert err < tol, (mesh, itype, err)
        assert (got["logits"].argmax(-1) == logits_ref.argmax(-1)).all()
        if itype == "q8":
            assert got["cache_heads"] == HP.n_text_head // mesh[1]
            np.testing.assert_allclose(got["scale"], got["scale_ref"], rtol=1e-5)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)], ids=["tp2", "tp4", "dp2xtp2"])
def test_q8_row_scales_span_the_heads(ranks, mesh):
    for r in ranks[mesh]:
        assert r[(*mesh, "rows")] == {"scale_equal": True, "codes_equal": True}


def test_window_decoder_tokens_exact_tp2(ranks, mel):
    W = 4
    eot, beg = HP.n_vocab - 2, HP.n_vocab - 10
    jp = jax.tree.map(jnp.asarray, whisper_params(HP, SEED))
    enc = JM.encode(jp, jnp.asarray(mel), HP, dtype=jnp.float32)
    xk1, xv1 = JM.compute_cross_kv(jp, enc, HP, dtype=jnp.float32)
    xk = jnp.broadcast_to(xk1[None], (W,) + xk1.shape)
    xv = jnp.broadcast_to(xv1[None], (W,) + xv1.shape)
    prompts = jnp.tile(jnp.asarray([[0, 0, 0, 0, 0, 0, 1, 2]], jnp.int32), (W, 1))
    fn = JDL.make_window_decoder(HP, 1, 8, jnp.float32, False, False, eot, beg,
                                 n_windows=W)
    ref = fn(jp, prompts, jnp.full((W,), 2, jnp.int32), xk, xv,
             jnp.zeros(HP.n_vocab), jnp.zeros(HP.n_vocab), jnp.zeros((W,)),
             jnp.zeros((W,), jnp.int32), jnp.full((W,), 3000, jnp.int32), jnp.int32(0),
             jax.vmap(jax.random.PRNGKey)(jnp.arange(W)))
    ref_tok = np.asarray(ref.tok_id)[:, 0]
    ref_n = np.asarray(ref.n_tok)[:, 0]
    assert ref_n.max() > 0
    for r in ranks[(1, 2)]:
        got = r["window"]
        assert got["eager_windows"] == W          # gloo: the eager loop
        np.testing.assert_array_equal(got["n_tok"], ref_n)
        for w in range(W):
            np.testing.assert_array_equal(got["tok_id"][w, :ref_n[w]], ref_tok[w, :ref_n[w]])


def test_medium_width_decode_chain_tp4(ranks):
    hp = MEDIUM
    jp = jax.tree.map(jnp.asarray, whisper_params(hp, 5, ("dec",)))
    xk, xv = (jnp.asarray(a) for a in medium_xkv(hp, 5))
    B = 4

    @jax.jit
    def chain(params, xk, xv):
        cache = JM.new_cache(hp, B, jnp.float32)
        toks = jnp.arange(B, dtype=jnp.int32)[:, None] + 17
        outs = []
        for step in range(3):
            pos = jnp.full((B, 1), step, jnp.int32)
            logits, cache = JM.decode_step(params, toks, pos, jnp.int32(step), cache,
                                           xk, xv, hp, dtype=jnp.float32, unroll=False)
            toks = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            outs.append(logits)
        return jnp.stack(outs)

    ref = np.asarray(chain(jp, xk, xv))
    got = ranks[(1, 4)][0]["medium"]
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 1e-4, rel
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def _tp_dim(spec):
    return spec.index("tp") if "tp" in spec else None


def test_spec_table_matches_jax():
    jt = jax.tree.map(_tp_dim, JS.param_specs(_hp()),
                      is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert PS.param_specs(HP) == jt
    assert PS.cross_kv_spec() == _tp_dim(JS.cross_kv_spec())
    assert PS.kv_cache_spec() == _tp_dim(JS.kv_cache_spec())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fused_qkv_split_reassembles(n):
    L, S, H = 2, 64, 8
    d = S // H
    w = torch.randn(L, S, 3 * S, generator=torch.Generator().manual_seed(n))
    parts = [PS.split_heads_fused(w, 2, H, n, r) for r in range(n)]
    assert all(p.shape == (L, S, 3 * S // n) for p in parts)
    # rank r holds heads r*H/n.. of q, then of k, then of v
    for t in range(3):
        got = torch.cat([p.unflatten(2, (3, H // n, d))[:, :, t] for p in parts], 2)
        assert torch.equal(got.flatten(2), w[..., t * S:(t + 1) * S])
    b = torch.randn(L, 3 * S)
    pb = [PS.split_heads_fused(b, 1, H, n, r) for r in range(n)]
    for t in range(3):
        got = torch.cat([p.unflatten(1, (3, -1))[:, t] for p in pb], 1)
        assert torch.equal(got, b[:, t * S:(t + 1) * S])


def test_packed_weights_raise(tmp_path):
    import whisper_tpu_torch as W
    from whisper_tpu_torch.utils.synth import write_synth_model

    hp = WhisperHParams(n_vocab=51865, n_audio_ctx=32, n_audio_state=64, n_audio_head=2,
                        n_audio_layer=1, n_text_ctx=64, n_text_state=64, n_text_head=2,
                        n_text_layer=1, n_mels=80)
    path = str(tmp_path / "m-q8_0.bin")
    write_synth_model(path, hp, seed=0, qtype="q8_0")
    specs = PS.param_specs(hp)
    heads = {"enc": 2, "dec": 2}
    packed = W.load(path, device="cpu", use_packed_weights=True).params
    with pytest.raises(ValueError, match="dense parameter tree only"):
        PS.shard_tree(packed, specs, 2, 0, heads)
    dense = W.load(path, device="cpu", use_packed_weights=False).params
    local = PS.shard_tree(dense, specs, 2, 1, heads)
    assert local["dec"]["blocks"]["qkv_w"].shape == (1, 64, 96)
    assert local["dec"]["blocks"]["o_w"].shape == (1, 32, 64)
    assert local["dec"]["tok_embd"] is dense["dec"]["tok_embd"]
