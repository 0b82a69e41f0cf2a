"""The port's vmapped window mode (`make_window_decoder(vmap_windows=True)`)
against the JAX package's (`jax.vmap` of the one-window decoder) and against
the port's own one-window decoder, on the CPU, on the DECISIVE model and
audio of tests/test_torch_batching.py (its fixtures are imported from
there): W = 2 windows of different prompts and seeks, greedy at t = 0.

Against JAX: tokens, timestamps and flags identical; prompt_probs to rtol
2e-3 and atol 1e-5 and cumulative logprobs to 1e-4, as
tests/test_torch_batching_native.py holds the native mode.  Against the
one-window decoder, window by window: every field equal, since each window
is that decoder's run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu_torch as W
from test_torch_batching import HP, model_path, one_torch_thread, pcm  # noqa: F401
from whisper_tpu.decoding import device_loop as JDL
from whisper_tpu_torch.decoding import device_loop as TDL
from whisper_tpu_torch.models.whisper import model as TM

N_WINDOWS, BUCKET = 2, 8


def _stack(xs):
    return TM.XK8(*map(torch.stack, zip(*xs))) if isinstance(xs[0], TM.XK8) else torch.stack(xs)


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_vmapped_decoder_matches_jax_and_one_window(model_path, pcm, kv_itype):
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True, kv_itype=kv_itype)
    v = tctx.vocab
    prompts = [[v.token_sot, v.lang_token(0), v.token_transcribe],
               [v.token_prev, 100, 200, v.token_sot, v.lang_token(0), v.token_transcribe]]
    seeks, ends = [0, 3000], [3500, 3500]
    xs = {}
    for name, ctx in (("jax", jctx), ("torch", tctx)):
        ctx.pcm_to_mel(pcm)
        xs[name] = []
        for s in seeks:
            ctx.encode_window(s)
            xs[name].append((ctx.xk, ctx.xv))
    base, initial = TDL.build_masks(tctx.filter_tables, W.TranscribeParams())
    rows = np.zeros((N_WINDOWS, BUCKET), np.int64)
    for i, p in enumerate(prompts):
        rows[i, :len(p)] = p
    lens = [len(p) for p in prompts]

    jfn = JDL.make_window_decoder(HP, 1, BUCKET, jnp.float32, False, False, v.token_eot,
                                  v.token_beg, vmap_windows=True, kv_itype=kv_itype)
    jst = lambda k: jax.tree.map(lambda *a: jnp.stack(a), *[x[k] for x in xs["jax"]])
    jr = jax.tree.map(np.asarray, jfn(
        jctx.params, jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens, jnp.int32),
        jst(0), jst(1), jnp.asarray(base), jnp.asarray(initial),
        jnp.zeros(N_WINDOWS, jnp.float32), jnp.asarray(seeks, jnp.int32),
        jnp.asarray(ends, jnp.int32), jnp.int32(0),
        jnp.stack([jax.random.PRNGKey(7)] * N_WINDOWS)))
    tfn = TDL.make_window_decoder(HP, 1, BUCKET, torch.float32, False, False, v.token_eot,
                                  v.token_beg, vmap_windows=True, kv_itype=kv_itype)
    tr = tfn(tctx.params, torch.from_numpy(rows), lens,
             _stack([x[0] for x in xs["torch"]]), _stack([x[1] for x in xs["torch"]]),
             torch.from_numpy(base), torch.from_numpy(initial), [0.0] * N_WINDOWS,
             seeks, ends, 0, [7] * N_WINDOWS)

    assert tr.tok_id.shape[:2] == (N_WINDOWS, 1) and tr.prompt_probs.shape[0] == N_WINDOWS
    assert tfn.windows == N_WINDOWS
    for name in ("n_tok", "result_len", "seek_delta", "has_ts", "failed", "completed"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name), err_msg=name)
    assert tr.n_tok.min() > 1
    for w in range(N_WINDOWS):
        n = int(tr.n_tok[w, 0])
        for name in ("tok_id", "tok_tid"):
            np.testing.assert_array_equal(getattr(tr, name)[w, 0, :n],
                                          getattr(jr, name)[w, 0, :n], err_msg=name)
    np.testing.assert_allclose(tr.prompt_probs, jr.prompt_probs, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(tr.sum_logprobs, jr.sum_logprobs, rtol=1e-4, atol=1e-5)

    one = TDL.make_window_decoder(HP, 1, BUCKET, torch.float32, False, False, v.token_eot,
                                  v.token_beg, kv_itype=kv_itype)
    for w in range(N_WINDOWS):
        r1 = one(tctx.params, torch.from_numpy(rows[w]), lens[w], *xs["torch"][w],
                 torch.from_numpy(base), torch.from_numpy(initial), 0.0, seeks[w], ends[w],
                 0, 7)
        for name, a in r1._asdict().items():
            np.testing.assert_array_equal(getattr(tr, name)[w], a, err_msg=name)
