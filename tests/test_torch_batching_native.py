"""The port's natively batched window decoder against the JAX package's
(`make_window_decoder(n_windows=W)`, JAX `decode_windows_native`) on the
CPU, on the DECISIVE model and the windows of tests/test_torch_batching.py
(its fixtures are imported from there): W windows of different prompt
lengths (the batch left-pads them) and seeks, greedy and beam search.
Tokens, timestamps and flags identical; prompt_probs to rtol 2e-3 and atol
1e-5, as tests/test_batching.py holds the JAX package's batched rows to
its single ones; cumulative logprobs to 1e-4.  Kept in a file of its own
so that a worker of its own can run it.
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


def _stack(xs):
    return TM.XK8(*map(torch.stack, zip(*xs))) if isinstance(xs[0], TM.XK8) else torch.stack(xs)


@pytest.mark.parametrize("strategy,n_windows,kv_itype", [
    ("greedy", 2, "f16"), ("greedy", 3, "q8"), ("beam", 2, "q8"), ("beam", 3, "f16")])
def test_native_decoder_matches_jax(model_path, pcm, strategy, n_windows, kv_itype):
    G = 5 if strategy == "beam" else 1
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True, kv_itype=kv_itype)
    v = tctx.vocab
    prompts = [[v.token_sot, v.lang_token(0), v.token_transcribe],
               [v.token_prev, 100, 200, v.token_sot, v.lang_token(0), v.token_transcribe],
               [v.token_sot, v.lang_token(0), v.token_transcribe, v.token_not]][:n_windows]
    seeks = [0, 3000, 0][:n_windows]
    ends = [3500, 3500, 2000][:n_windows]
    bt = 8
    xs = {}
    for name, ctx in (("jax", jctx), ("torch", tctx)):
        ctx.pcm_to_mel(pcm)
        xs[name] = []
        for s in seeks:
            ctx.encode_window(s)
            xs[name].append((ctx.xk, ctx.xv))
    params = (W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
              if strategy == "beam" else W.TranscribeParams())
    base, initial = TDL.build_masks(tctx.filter_tables, params)
    rows = np.zeros((n_windows, bt), np.int64)
    for i, p in enumerate(prompts):
        rows[i, :len(p)] = p
    lens = [len(p) for p in prompts]

    jfn = JDL.make_window_decoder(HP, G, bt, jnp.float32, False, False, v.token_eot,
                                  v.token_beg, kv_itype=kv_itype, strategy=strategy,
                                  n_windows=n_windows)
    jst = lambda k: jax.tree.map(lambda *a: jnp.stack(a), *[x[k] for x in xs["jax"]])
    jr = jax.tree.map(np.asarray, jfn(
        jctx.params, jnp.asarray(rows.astype(np.int32)), jnp.asarray(lens, jnp.int32),
        jst(0), jst(1), jnp.asarray(base), jnp.asarray(initial),
        jnp.zeros(n_windows, jnp.float32), jnp.asarray(seeks, jnp.int32),
        jnp.asarray(ends, jnp.int32), jnp.int32(0),
        jnp.stack([jax.random.PRNGKey(7)] * n_windows)))
    tfn = TDL.make_window_decoder(HP, G, bt, torch.float32, False, False, v.token_eot,
                                  v.token_beg, kv_itype=kv_itype, strategy=strategy,
                                  n_windows=n_windows)
    tr = tfn(tctx.params, torch.from_numpy(rows), lens,
             _stack([x[0] for x in xs["torch"]]), _stack([x[1] for x in xs["torch"]]),
             torch.from_numpy(base), torch.from_numpy(initial), [0.0] * n_windows,
             seeks, ends, 0, [7] * n_windows)

    assert tr.tok_id.shape[:2] == (n_windows, G) and tr.prompt_probs.shape[0] == n_windows
    assert tfn.windows == n_windows
    for name in ("n_tok", "result_len", "seek_delta", "has_ts", "failed", "completed"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name), err_msg=name)
    assert tr.n_tok.min() > 1
    for w in range(n_windows):
        for g in range(G):
            n = int(tr.n_tok[w, g])
            for name in ("tok_id", "tok_tid"):
                np.testing.assert_array_equal(getattr(tr, name)[w, g, :n],
                                              getattr(jr, name)[w, g, :n], err_msg=name)
    np.testing.assert_allclose(tr.prompt_probs, jr.prompt_probs, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(tr.sum_logprobs, jr.sum_logprobs, rtol=1e-4, atol=1e-5)
