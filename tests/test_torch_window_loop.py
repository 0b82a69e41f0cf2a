"""The window loop's step function and its flag reads, on the CPU, against
the JAX package.

`make_window_decoder` runs one step function over a LoopState of tensors.
On the card each attention-bucket segment's step is a captured CUDA graph;
on the CPU the same step runs eagerly.  Either way the host reads the "all
lanes done" flag once every FLAG_EVERY = k steps, so a window runs up to
k - 1 steps past its end, and those steps change no result.  So k in
{1, 3, 8} must give the same WindowResult bit for bit, and the one the JAX
package's `decode_window` gives on the DECISIVE model (utils/synth.py
make_decisive): token ids, timestamps and flags exactly, cumulative
logprobs to 1e-4, as tests/test_torch_beam.py holds the beam window.  Two
consecutive windows (seek 0, then 3000, with another cross-K/V) run
through one decoder, whose LoopState is reused.

Flag reads: a window that ends at step s (the last lane's n_tok) runs
min(n_max, ceil(s / k) * k) steps and makes ceil(steps / k) + 1 reads (the
flags and the one read of the results); one that runs to n_max makes
ceil(n_max / k).

`decode_step` with a 0-d tensor `kv_head` (the captured step's form) must
equal the host-int form bit for bit, a write clamped at the last cells
included, and the JAX decode_step to 1e-4 of the largest logit with an f16
cache (the f32 tolerance of tests/test_torch_model.py).  With a q8 cache
the two packages' f32 K/V rows can round to int8 codes one apart (the
codes are held to within 1); one code is 1/127 of its row's scale, so the
logits, and the scales of the rows written after it, are held to 4e-3
(half a code) of the largest.  `_apply_filters` with device
scalars is held to JAX as tests/test_torch_device_loop.py holds the
host-number form.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu as J
import whisper_tpu_torch as W
from whisper_tpu.decoding import device_loop as JDL
from whisper_tpu.models.whisper import model as JM
from whisper_tpu_torch.decoding import device_loop as TDL
from whisper_tpu_torch.models.whisper import model as TM
from whisper_tpu_torch.models.whisper.convert import params_from_numpy
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
N_BEAM = 5
FIELDS = ("tok_id", "tok_tid", "tok_p", "tok_plog", "tok_pt", "tok_ptsum", "n_tok",
          "result_len", "seek_delta", "has_ts", "failed", "completed",
          "sum_logprobs", "prompt_probs")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # many small ops per step: with other test processes on the cores,
    # PyTorch's intra-op threads spend more time waiting on each other than
    # computing (the results do not depend on the thread count)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("window") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    # two windows: ~35 s of seeded noise
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def _params(pkg, strategy):
    if strategy == "beam":
        return pkg.TranscribeParams.default(pkg.SamplingStrategy.BEAM_SEARCH)
    return pkg.TranscribeParams()


def _windows(pkg, ctx, pcm, strategy):
    """The t = 0 window at seek 0 and at seek 3000 (each after its own
    encode), as full.py's device-loop attempt calls it."""
    ctx.pcm_to_mel(pcm)
    v = ctx.vocab
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    out = []
    for seek in (0, 3000):
        ctx.encode_window(seek)
        out.append(ctx.decode_window_device(
            prompt, N_BEAM if strategy == "beam" else 1, 0.0, seek,
            ctx.n_len_org, _params(pkg, strategy), False, rng_seed=seek,
            strategy=strategy))
    return out


def _windows_at_period(ctx, pcm, strategy, k):
    """`_windows` with k steps per flag read: (results, steps run, reads)."""
    counts = lambda: [(fn.steps, fn.readbacks) for fn in ctx._window_fns.values()]
    before = counts() or [(0, 0)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TDL, "FLAG_EVERY", k)
        res = _windows(W, ctx, pcm, strategy)
    (steps, reads), = counts()             # one decoder serves both windows
    return res, steps - before[0][0], reads - before[0][1]


def _expected_counts(results, k, n_max):
    """(steps, reads): a window whose last lane ends at step s runs
    min(n_max, ceil(s / k) * k) steps."""
    steps = reads = 0
    for r in results:
        n = min(n_max, math.ceil(int(r.n_tok.max()) / k) * k)
        n_reads = math.ceil(n / k) + 1 if n < n_max else math.ceil(n_max / k)
        assert n_reads <= math.ceil(n_max / k) + 2
        steps, reads = steps + n, reads + n_reads
    return steps, reads


_RUNS = {}


def _run(model_path, pcm, strategy, kv_itype, k):
    """{"jax": [results], k: ([results], steps, readbacks)}, cached per
    (strategy, kv cache); the port's decoder is held across k values."""
    runs = _RUNS.setdefault((strategy, kv_itype), {})
    if "jax" not in runs:
        jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
        runs["jax"] = _windows(J, jctx, pcm, strategy)
        runs["ctx"] = W.load(model_path, device="cpu", use_packed_weights=True,
                             kv_itype=kv_itype)
    if k not in runs:
        runs[k] = _windows_at_period(runs["ctx"], pcm, strategy, k)
    return runs


def check_window_loop(model_path, pcm, strategy, kv_itype, k):
    runs = _run(model_path, pcm, strategy, kv_itype, k)
    got, steps, readbacks = runs[k]
    base = _run(model_path, pcm, strategy, kv_itype, 1)[1][0]
    for tr, jr, br in zip(got, runs["jax"], base):
        # the same bits as k = 1
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(tr, name), getattr(br, name),
                                          err_msg=name)
        # the JAX package's window
        assert int(tr.n_tok.max()) > 2
        for name in ("n_tok", "tok_id", "tok_tid", "result_len", "seek_delta",
                     "has_ts", "failed", "completed"):
            np.testing.assert_array_equal(getattr(tr, name),
                                          np.asarray(getattr(jr, name)), err_msg=name)
        np.testing.assert_allclose(tr.sum_logprobs, np.asarray(jr.sum_logprobs),
                                   rtol=0, atol=1e-4)
    assert (steps, readbacks) == _expected_counts(got, k, HP.n_text_ctx // 2 - 4)


# beam search's cases: test_torch_window_loop_beam.py (a file of their own,
# so that xdist's --dist loadfile runs them beside these)
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_greedy_window_loop_matches_jax_for_every_flag_period(model_path, pcm,
                                                              kv_itype, k):
    check_window_loop(model_path, pcm, "greedy", kv_itype, k)


# a 32-cell text context: n_max = 12 steps over two bucket segments (8, 16)
HP_SHORT = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                          n_audio_head=2, n_audio_layer=2, n_text_ctx=32,
                          n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def short_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("short") / "short-q5_0.bin"
    write_synth_model(str(path), HP_SHORT, seed=3, qtype="q5_0")
    return str(path)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_flag_reads_of_windows_that_run_to_n_max(short_path, pcm, strategy):
    # random weights rarely end a window in 12 tokens, so windows run to
    # n_max here
    ctx = W.load(short_path, device="cpu", use_packed_weights=True, kv_itype="q8")
    seen = {}
    for k in (1, 3, 8):
        res, steps, reads = _windows_at_period(ctx, pcm, strategy, k)
        assert (steps, reads) == _expected_counts(res, k, 12)
        seen[k] = res
    assert any(int(r.n_tok.max()) == 12 for r in seen[1])
    for k in (3, 8):
        for a, b in zip(seen[k], seen[1]):
            for name in FIELDS:
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                              err_msg=name)


@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_decode_step_tensor_kv_head(short_path, kv_itype):
    hp = HP_SHORT
    jctx = J.load(short_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(short_path, device="cpu", use_packed_weights=True, kv_itype=kv_itype)
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((hp.n_audio_ctx, hp.n_audio_state)).astype(np.float32)
    jk, jv = JM.compute_cross_kv(jctx.params, jnp.asarray(enc), hp, dtype=jnp.float32)
    tk, tv = params_from_numpy(np.asarray(jk)), params_from_numpy(np.asarray(jv))
    C = hp.n_text_ctx
    jcache = jctx.new_cache(2)
    caches = [tctx.new_cache(2), tctx.new_cache(2)]     # int and tensor kv_head
    # a 4-token pass, steps, and writes clamped onto the last cells: kv_head
    # C - 2 with 4 tokens lands on C - 4 .. C - 1, kv_head C + 5 on C - 1
    for n_tok, kv_head in ((4, 0), (1, 4), (1, 5), (4, C - 2), (1, C + 5)):
        toks = rng.integers(0, 50000, (2, n_tok))
        pos = np.minimum(kv_head + np.arange(n_tok), C - 1)[None].repeat(2, 0)
        jl, jcache = JM.decode_step(jctx.params, jnp.asarray(toks), jnp.asarray(pos),
                                    jnp.int32(kv_head), jcache, jk, jv, hp,
                                    dtype=jnp.float32, attn_ctx=C)
        outs = []
        for cache, head in zip(caches, (kv_head, torch.tensor(kv_head))):
            tl, _ = TM.decode_step(tctx.params, torch.from_numpy(toks),
                                   torch.from_numpy(pos), head, cache, tk, tv, hp,
                                   dtype=torch.float32, attn_ctx=C)
            outs.append(tl)
        assert torch.equal(outs[0], outs[1])
        for a, b in zip(*caches):
            assert torch.equal(a, b)
        jl = np.asarray(jl)
        np.testing.assert_allclose(outs[1].numpy(), jl, rtol=0,
                                   atol=(4e-3 if kv_itype == "q8" else 1e-4)
                                   * np.abs(jl).max())
    if kv_itype == "q8":
        np.testing.assert_allclose(caches[1].scale.numpy(), np.asarray(jcache.scale),
                                   rtol=0, atol=4e-3 * np.abs(np.asarray(jcache.scale)).max())
        assert np.abs(caches[1].kv.numpy().astype(int)
                      - np.asarray(jcache.kv).astype(int)).max() <= 1
    else:
        ref = np.asarray(jcache.kv)
        np.testing.assert_allclose(caches[1].kv.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # the clamped writes filled the last four cells
    assert caches[1].kv[:, :, :, :, C - 4:].abs().sum(-1).gt(0).all()


V, EOT, BEG = 300, 150, 200
LAST = np.array([-1, 40, 230])
PENULT = np.array([-1, 210, 220])
HAS_TS = np.array([False, True, True])
SEEK_DELTA = np.array([3000, 24, 60])


@pytest.mark.parametrize("st_i", [0, 1, 2, 7])
@pytest.mark.parametrize("max_tokens", [0, 3])
def test_filters_with_device_scalars_match_jax(st_i, max_tokens):
    rng = np.random.default_rng(st_i)
    raw = (4.0 * rng.standard_normal((3, V))).astype(np.float32)
    base = np.where(rng.random(V) < 0.05, -np.inf, 0.0).astype(np.float32)
    initial = np.where(rng.random(V) < 0.05, -np.inf, 0.0).astype(np.float32)
    state = (LAST, PENULT, HAS_TS, SEEK_DELTA)
    for temp in (0.0, 0.4):
        j = JDL._apply_filters(
            jnp.asarray(raw), st_i, *(jnp.asarray(a) for a in state),
            jnp.asarray(base), jnp.asarray(initial), jnp.full(3, temp, jnp.float32),
            max_tokens, EOT, BEG, False, False)
        t = TDL._apply_filters(
            torch.from_numpy(raw), torch.tensor(st_i), *(torch.from_numpy(a) for a in state),
            torch.from_numpy(base), torch.from_numpy(initial),
            torch.tensor(temp, dtype=torch.float32), torch.tensor(max_tokens),
            EOT, BEG, False, False)
        h = TDL._apply_filters(
            torch.from_numpy(raw), st_i, *(torch.from_numpy(a) for a in state),
            torch.from_numpy(base), torch.from_numpy(initial), temp, max_tokens,
            EOT, BEG, False, False)
        for a, b, c in zip(t, j, h):
            b = np.asarray(b)
            np.testing.assert_array_equal(np.isneginf(a.numpy()), np.isneginf(b))
            fin = np.isfinite(b)
            scale = max(1.0, float(np.abs(b[fin]).max()))
            np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=0, atol=1e-6 * scale)
            assert torch.equal(a, c)
