"""Native window batching in the port, on the CPU: the batched decode step
and grouped beam selection against the JAX package, a window decoded in a
batch against the same window decoded solo, and the WindowBatcher.

`decode_step` with `xkv_group` = G: W windows of G lanes share their
window's cross-K/V, and every row has its own pad mask (the left-pad cells
of a natively batched prompt).  Held to the JAX decode_step as
tests/test_torch_model.py holds the unbatched step: 1e-4 of the largest
logit with an f16 cache, 4e-3 with a q8 one (the two packages' K/V rows
can round to int8 codes one apart).

Native against solo in the port: each window of a batch gives the tokens
it gives alone, at t = 0 (greedy and beam search, on the DECISIVE model of
utils/synth.py) and at t > 0 (best-of lanes: a window draws from its own
generator, seeded with its rng_seed, whatever shares the batch).  The t > 0
case runs on the plain random-weight file: the decisive one's margins make
a draw at t = 0.7 the argmax, which would not show whose numbers a lane
drew.
"""

import threading
import time

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
from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
from whisper_tpu_torch.runtime.batching import WindowBatcher
from whisper_tpu_torch.utils.synth import write_synth_model

HP = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                    n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                    n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # many small ops per step: beside other test processes, PyTorch's
    # intra-op threads wait on each other more than they compute
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("batching") / "decisive-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0", decisive=True)
    return str(path)


@pytest.fixture(scope="module")
def plain_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("batching") / "plain-q5_0.bin"
    write_synth_model(str(path), HP, seed=1, qtype="q5_0")
    return str(path)


@pytest.fixture(scope="module")
def pcm():
    return (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("kv_itype", ["f16", "q8"])
def test_decode_step_xkv_group_matches_jax(model_path, kv_itype, G):
    # W = 2 windows: a prompt pass on one row per window, left-padded
    # (row 0 has 2 pad cells, row 1 none) with the pad mask and each pad
    # query seeing itself, then one step of W * G rows against the rows'
    # pad masks, each window's lanes sharing its cross-K/V
    jctx = J.load(model_path, use_packed_weights=True, kv_itype=kv_itype)
    tctx = W.load(model_path, device="cpu", use_packed_weights=True, kv_itype=kv_itype)
    Wn, L, H, d, Tc, bt = 2, HP.n_text_layer, HP.n_text_head, 64, 1500, 4
    rng = np.random.default_rng(3)
    xk, xv = (rng.standard_normal((L, Wn, H, Tc, d)).astype(np.float32) for _ in range(2))
    jxk, jxv = jnp.asarray(xk), jnp.asarray(xv)
    txk, txv = torch.from_numpy(xk), torch.from_numpy(xv)
    if kv_itype == "q8":                  # the int8 cross planes too
        jxk, jxv = (JM.XK8(*JM._quantize_rows(a)) for a in (jxk, jxv))
        txk, txv = (TM.XK8(*TM._quantize_rows(a)) for a in (txk, txv))
    v = jctx.vocab
    toks = np.array([[v.token_sot, v.token_sot, v.token_sot, v.token_transcribe],
                     [v.token_sot, 440, 441, v.token_transcribe]])
    shift = np.array([2, 0])
    C = HP.n_text_ctx
    cells = np.arange(C)
    is_pad = cells[None, :] < shift[:, None]
    diag = cells[:bt, None] == cells[None, :]
    mprompt = np.where(is_pad[:, None, :] & ~diag[None], -np.inf, 0.0).astype(np.float32)[:, None]
    pos = np.clip(np.arange(bt)[None, :] - shift[:, None], 0, C - 1)
    mstep = np.repeat(np.where(is_pad, -np.inf, 0.0).astype(np.float32)[:, None, None], G, 0)
    step_toks = np.array([[1234 + r] for r in range(Wn * G)])
    step_pos = np.repeat(bt - shift, G)[:, None]

    jcache = JM.new_cache(HP, Wn, jnp.float32, itype=kv_itype)
    tcache = tctx.new_cache(Wn)
    jl, jcache = JM.decode_step(jctx.params, jnp.asarray(toks), jnp.asarray(pos), jnp.int32(0),
                                jcache, jxk, jxv, HP, dtype=jnp.float32,
                                attn_mask=jnp.asarray(mprompt), attn_ctx=128)
    tl, tcache = TM.decode_step(tctx.params, torch.from_numpy(toks), torch.from_numpy(pos), 0,
                                tcache, txk, txv, HP, dtype=torch.float32,
                                attn_mask=torch.from_numpy(mprompt), attn_ctx=128)
    tol = 4e-3 if kv_itype == "q8" else 1e-4
    close(tl[:, -1], np.asarray(jl)[:, -1], tol)
    # the lanes of each window start from its prompt cache
    jcache = type(jcache)(*(jnp.repeat(a, G, axis=1) for a in jcache))
    tcache = type(tcache)(*(a.repeat_interleave(G, 1) for a in tcache))
    jl, _ = JM.decode_step(jctx.params, jnp.asarray(step_toks), jnp.asarray(step_pos),
                           jnp.int32(bt), jcache, jxk, jxv, HP, dtype=jnp.float32,
                           attn_mask=jnp.asarray(mstep), xkv_group=G, attn_ctx=128)
    tl, _ = TM.decode_step(tctx.params, torch.from_numpy(step_toks),
                           torch.from_numpy(step_pos), torch.tensor(bt), tcache, txk, txv,
                           HP, dtype=torch.float32, attn_mask=torch.from_numpy(mstep),
                           xkv_group=G, attn_ctx=128)
    assert torch.isfinite(tl).all()
    close(tl, jl, tol)
    assert (tl[:, 0].argmax(-1).numpy() == np.asarray(jl)[:, 0].argmax(-1)).all()


def test_beam_select_grouped_matches_jax():
    rng = np.random.default_rng(0)
    Wn, G, V, beg = 3, 4, 64, 50
    logprobs = np.log(rng.dirichlet(np.ones(V), Wn * G)).astype(np.float32)
    logprobs[1, 3] = -np.inf                       # a suppressed candidate
    logprobs[5] = logprobs[4]                      # duplicate sequences in a group
    live = np.ones(Wn * G, bool)
    live[[2, 9]] = False
    done = ~live
    sums = rng.standard_normal(Wn * G).astype(np.float32)
    hashes = rng.integers(0, 2 ** 32, (Wn * G, 2), dtype=np.uint64)
    hashes[5] = hashes[4]
    for step_i in (0, 3):
        j = JDL._beam_select_grouped(jnp.asarray(logprobs), JDL.LoopState(
            i=jnp.int32(step_i), cache=None, logits_row=None, rng=None,
            seq_hash=jnp.asarray(hashes.astype(np.uint32)), last_id=None,
            penult_id=None, has_ts=None, seek_delta=None, result_len=None,
            failed=jnp.asarray(np.zeros_like(done)), completed=jnp.asarray(done),
            sum_logprobs=jnp.asarray(sums), tok_id=None, tok_tid=None, tok_p=None,
            tok_plog=None, tok_pt=None, tok_ptsum=None, n_tok=None), beg, Wn, G)
        t = TDL._beam_select_grouped(
            torch.from_numpy(logprobs), torch.from_numpy(done),
            torch.zeros(Wn * G, dtype=torch.bool), torch.from_numpy(sums),
            torch.from_numpy(hashes.astype(np.int64)), torch.tensor(step_i), beg, Wn, G)
        src, tok, score, new_hash = (a.numpy() for a in t)
        np.testing.assert_array_equal(src, np.asarray(j[0]))
        np.testing.assert_array_equal(tok, np.asarray(j[1]))
        np.testing.assert_allclose(score, np.asarray(j[2]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(new_hash, np.asarray(j[3]).astype(np.int64))
        # parents are global and stay inside their window's group
        assert ((src // G) == np.arange(Wn * G) // G).all()


def _native_vs_solo(ctx, pcm, strategy, temperature, n_lanes, seeks):
    """Each window of `seeks` decoded solo and all of them natively
    batched through the port's window decoders (prompts of different
    lengths: the batch left-pads them)."""
    v = ctx.vocab
    params = (W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
              if strategy == "beam" else W.TranscribeParams())
    prompts = [[v.token_sot, v.lang_token(0), v.token_transcribe],
               [v.token_prev, 300, 301, 302, v.token_sot, v.lang_token(0),
                v.token_transcribe]][:len(seeks)]
    ctx.pcm_to_mel(pcm)
    base, initial = (torch.from_numpy(a) for a in TDL.build_masks(
        TDL.LogitFilterTables(v, HP.n_audio_ctx), params))
    bt = 8
    rows, solo, xks, xvs = [], [], [], []
    key = (n_lanes, bt, False, False, strategy)
    for w, (seek, prompt) in enumerate(zip(seeks, prompts)):
        ctx.encode_window(seek)
        p = np.zeros(bt, np.int64)
        p[:len(prompt)] = prompt
        rows.append(p)
        xks.append(ctx.xk)
        xvs.append(ctx.xv)
        solo.append(ctx.window_decoder(key)(
            ctx.params, torch.from_numpy(p), len(prompt), ctx.xk, ctx.xv, base, initial,
            temperature, seek, seek + 3000, 0, 11 + w))
    batched = ctx.window_decoder(key, n_windows=len(seeks))(
        ctx.params, torch.from_numpy(np.stack(rows)), [len(p) for p in prompts],
        torch.stack(xks), torch.stack(xvs), base, initial, [temperature] * len(seeks),
        list(seeks), [s + 3000 for s in seeks], 0, [11 + w for w in range(len(seeks))])
    return solo, batched


@pytest.mark.parametrize("strategy,temperature,n_lanes", [
    ("greedy", 0.0, 1), ("beam", 0.0, 5), ("greedy", 0.7, 3)],
    ids=["greedy", "beam", "best_of_t0.7"])
def test_native_window_matches_solo(model_path, plain_path, pcm, strategy,
                                    temperature, n_lanes):
    path = plain_path if temperature > 0 else model_path
    ctx = W.load(path, device="cpu", use_packed_weights=True)
    solo, batched = _native_vs_solo(ctx, pcm, strategy, temperature, n_lanes, (0, 3000))
    assert batched.tok_id.shape[:2] == (2, n_lanes)
    for w, s in enumerate(solo):
        np.testing.assert_array_equal(batched.n_tok[w], s.n_tok)
        assert s.n_tok.max() > 1
        for g in range(n_lanes):
            n = int(s.n_tok[g])
            np.testing.assert_array_equal(batched.tok_id[w, g, :n], s.tok_id[g, :n])
            np.testing.assert_array_equal(batched.tok_tid[w, g, :n], s.tok_tid[g, :n])
        for f in ("result_len", "seek_delta", "has_ts", "failed", "completed"):
            np.testing.assert_array_equal(getattr(batched, f)[w], getattr(s, f))
        np.testing.assert_allclose(batched.sum_logprobs[w], s.sum_logprobs, rtol=1e-4)
        np.testing.assert_allclose(batched.prompt_probs[w], s.prompt_probs,
                                   rtol=2e-3, atol=1e-5)
    if temperature > 0:
        # the lanes drew apart: the draws are real, not argmax
        assert len({tuple(r) for r in batched.tok_id[0]}) > 1


def test_batcher_straggler_deadline():
    """A queued request dispatches after max_wait_s even when the other
    live worker never submits (tests/test_batching.py's check)."""
    class _Ctx:
        def _decode_window_exec(self, key, *args):
            return ("ran", key, args), (0, 0)

    b = WindowBatcher(_Ctx(), n_workers=2, max_wait_s=0.1)
    t0 = time.perf_counter()
    out = b.submit("k", (1, 2))
    elapsed = time.perf_counter() - t0
    assert out == (("ran", "k", (1, 2)), (0, 0))
    assert 0.1 <= elapsed < 2.0
    assert (b.n_rounds, b.n_coalesced_rounds, b.max_round_size) == (1, 0, 1)


def test_batcher_group_error_reaches_every_worker():
    # a batched group that fails raises in each of its workers, and is not
    # rerun solo
    calls = []

    class _Ctx:
        params = None

        def window_decoder(self, key, n_windows=1):
            def fn(*args):
                calls.append(n_windows)
                raise RuntimeError("group failed")
            fn.graphs = fn.capture_us = 0
            return fn

        def _decode_window_exec(self, key, *args):
            calls.append("solo")
            return "solo"

    b = WindowBatcher(_Ctx(), n_workers=2, max_wait_s=5.0)
    errors = []

    def worker():
        try:
            b.submit("k", tuple(torch.zeros(1) for _ in range(11)))
        except RuntimeError as e:
            errors.append(str(e))
        finally:
            b.worker_done()

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errors == ["group failed"] * 2
    assert calls == [2] and b.n_coalesced_rounds == 1 and b.max_round_size == 2


class _Rows(tuple):
    """A two-field result whose fields split per request, as WindowResult's."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


def _batched_ctx(during_group):
    class _Ctx:
        params = None

        def window_decoder(self, key, n_windows=1):
            def fn(params, *args):
                during_group(fn)
                return _Rows(np.arange(n_windows), np.arange(n_windows) * 10)
            fn.graphs = fn.capture_us = 0
            return fn

    return _Ctx()


def _two_workers(b):
    out, errors = [None, None], []

    def worker(i):
        try:
            out[i] = b.submit("k", tuple(torch.full((1,), i) for _ in range(11)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            b.worker_done()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    return out


def test_batcher_charges_captures_once():
    # the graphs a batched group captured are charged to its first request
    # alone, so per-request timers summed over a round count them once
    def capture(fn):
        fn.graphs += 3
        fn.capture_us += 1000

    b = WindowBatcher(_batched_ctx(capture), n_workers=2, max_wait_s=5.0)
    out = _two_workers(b)
    assert sorted(c for _, c in out) == [(0, 0), (3, 1000)]
    assert sorted(tuple(int(a) for a in r) for r, _ in out) == [(0, 0), (1, 10)]
    assert (b.n_rounds, b.n_coalesced_rounds, b.max_round_size) == (1, 1, 2)


def test_batcher_runs_rounds_outside_its_lock():
    # while a round runs, another thread takes the batcher's lock (a request
    # arriving or leaving) without waiting for the round to end
    got_lock = []

    def other_thread_enters(fn):
        t = threading.Thread(target=b.worker_enter)
        t.start()
        t.join(timeout=5)
        got_lock.append(not t.is_alive())

    b = WindowBatcher(_batched_ctx(other_thread_enters), n_workers=2, max_wait_s=5.0)
    _two_workers(b)
    assert got_lock == [True] and b.n_live == 1 and b.n_running == 0


def test_digest_keeps_suppression_settings_apart(model_path, pcm):
    # two concurrent requests that differ only in suppress_nst must not share
    # a batch (the group shares the first request's masks)
    ctx = W.load(model_path, device="cpu", use_packed_weights=True)
    ctx.pcm_to_mel(pcm)
    ctx.encode_window(0)
    keys = []

    class _Recorder:
        def submit(self, key, args):
            keys.append(key)
            return ctx._decode_window_exec(key, *args)

    ctx.batcher = _Recorder()
    v = ctx.vocab
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    out = [ctx.decode_window_device(prompt, 1, 0.0, 0, 3500,
                                    W.TranscribeParams(suppress_nst=nst), False, 0)
           for nst in (False, True)]
    assert keys[0][:5] == keys[1][:5] and keys[0] != keys[1]
    assert all(r.n_tok[0] > 0 for r in out)
    # the same settings give the same key
    ctx.decode_window_device(prompt, 1, 0.0, 0, 3500, W.TranscribeParams(), False, 0)
    assert keys[2] == keys[0]
