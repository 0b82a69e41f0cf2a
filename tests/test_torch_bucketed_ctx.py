"""The port's `decode_step_bucketed` against the JAX package's and against
the port's own full-context step (tests/test_bucketed_ctx.py's cases).

The same seeded parameters (JAX `synth_params`, carried over with
`params_from_numpy`) and cross K/V go through both packages, f16 and q8
self-KV caches, one row and a window batch of 3 x 2 rows with left-pad
masks and grouped cross-K/V, across every bucket boundary of a 64-cell
cache (16/32/48/64).  Both chains are fed the JAX chain's tokens.  f32 on
the CPU: port against JAX within 1e-4 of max |logit| (the f32 sums in
another order, as tests/test_torch_model.py); bucketed against full within
2e-5 (the JAX test's bound: only the cells past the occupancy drop out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models.whisper import model as JM
from whisper_tpu.models.whisper.hparams import WhisperHParams as JHP
from whisper_tpu.utils.synth import synth_params as j_synth_params
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.convert import params_from_numpy
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams

DIMS = dict(n_vocab=128, n_audio_ctx=16, n_audio_state=32, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=64, n_text_state=32, n_text_head=4,
            n_text_layer=2, n_mels=80)
JAX_REL, FULL_REL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def params():
    hp = JHP(**DIMS)
    tree = jax.tree.map(np.asarray, j_synth_params(hp, jnp.float32))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= rel * scale, (err, scale)


def _chains(params, itype, n_rows, n_steps, head0, xkv_group, shift, seed):
    """(JAX bucketed logits, port bucketed, port full), each (steps, rows, V),
    the port chains fed the JAX chain's tokens."""
    jp, tp = params
    hp_j, hp_t = JHP(**DIMS), WhisperHParams(**DIMS)
    d = hp_t.n_text_state // hp_t.n_text_head
    W = n_rows // xkv_group
    lead = (hp_t.n_text_layer, W) if xkv_group > 1 else (hp_t.n_text_layer,)
    xk = np.random.default_rng(seed).standard_normal(
        lead + (hp_t.n_text_head, hp_t.n_audio_ctx, d)).astype(np.float32)
    xv = 0.3 * xk
    cells = np.arange(hp_t.n_text_ctx)
    mask = None
    if shift is not None:
        mask = np.where(cells[None, :] < shift[:, None], -np.inf,
                        0.0)[:, None, None, :].astype(np.float32)
    step_j = jax.jit(JM.decode_step_bucketed, static_argnums=(7,),
                     static_argnames=("dtype", "xkv_group"))
    cache_j = JM.new_cache(hp_j, n_rows, jnp.float32, itype=itype)
    caches_t = [TM.new_cache(hp_t, n_rows, torch.float32, itype=itype) for _ in range(2)]
    tok = np.zeros((n_rows, 1), np.int64)
    out_j, out_b, out_f = [], [], []
    for i in range(n_steps):
        base = np.zeros((n_rows, 1), np.int64) if shift is None else (8 - shift[:, None])
        pos = np.clip(base + i, 0, hp_t.n_text_ctx - 1)
        lj, cache_j = step_j(jp, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
                             jnp.int32(head0 + i), cache_j, jnp.asarray(xk), jnp.asarray(xv),
                             hp_j, dtype=jnp.float32,
                             attn_mask=None if mask is None else jnp.asarray(mask),
                             xkv_group=xkv_group)
        kw = dict(dtype=torch.float32, xkv_group=xkv_group,
                  attn_mask=None if mask is None else torch.from_numpy(mask))
        args = (torch.from_numpy(tok), torch.from_numpy(pos))
        lb, caches_t[0] = TM.decode_step_bucketed(
            tp, *args, torch.tensor(head0 + i), caches_t[0], torch.from_numpy(xk),
            torch.from_numpy(xv), hp_t, **kw)
        lf, caches_t[1] = TM.decode_step(tp, *args, head0 + i, caches_t[1],
                                         torch.from_numpy(xk), torch.from_numpy(xv), hp_t, **kw)
        out_j.append(np.asarray(lj[:, 0]))
        out_b.append(lb[:, 0].numpy())
        out_f.append(lf[:, 0].numpy())
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int64)
    return np.stack(out_j), np.stack(out_b), np.stack(out_f)


def test_attn_ctx_buckets_match_jax():
    for n_ctx in (448, 64, 24):
        for nb in (1, 2, 4):
            assert TM.attn_ctx_buckets(n_ctx, nb) == JM.attn_ctx_buckets(n_ctx, nb)


@pytest.mark.parametrize("itype", ["f16", "q8"])
def test_bucketed_matches_jax_and_full(params, itype):
    j, b, f = _chains(params, itype, 1, 50, 0, 1, None, 0)
    _close(b, j, JAX_REL)
    _close(b, f, FULL_REL)
    assert (b.argmax(-1) == f.argmax(-1)).all()


def test_bucketed_window_batch_with_pad_mask(params):
    shift = np.array([0, 0, 3, 3, 7, 7])
    j, b, f = _chains(params, "q8", 6, 40, 8, 2, shift, 1)
    _close(b, j, JAX_REL)
    _close(b, f, FULL_REL)
    assert (b.argmax(-1) == f.argmax(-1)).all()


def test_bucket_choice_and_host_kv_head(params, monkeypatch):
    """The smallest bucket at or above kv_head + n_tok, the last past it;
    a host int and a 0-d tensor pick the same."""
    _, tp = params
    hp = WhisperHParams(**DIMS)
    seen = []
    real = TM.decode_step
    monkeypatch.setattr(TM, "decode_step",
                        lambda *a, **k: seen.append(k["attn_ctx"]) or real(*a, **k))
    d = hp.n_text_state // hp.n_text_head
    xk = torch.zeros((hp.n_text_layer, hp.n_text_head, hp.n_audio_ctx, d))
    for head, n_tok, want in ((0, 1, 16), (15, 1, 16), (16, 1, 32), (30, 3, 48),
                              (47, 1, 48), (48, 1, 64), (63, 1, 64), (64, 1, 64)):
        for kv_head in (head, torch.tensor(head)):
            cache = TM.new_cache(hp, 1, torch.float32)
            toks = torch.zeros((1, n_tok), dtype=torch.long)
            TM.decode_step_bucketed(tp, toks, toks, kv_head, cache, xk, xk, hp,
                                    dtype=torch.float32)
            assert seen.pop() == want, (head, n_tok)
