"""Window decoding with the token-loop state resident on the device.

Port of whisper_tpu/decoding/device_loop.py for the GREEDY strategy (one
lane at t=0; `best_of` independent sampling lanes at t>0) and BEAM SEARCH at
t=0 (deterministic top-k candidates, cumulative-logprob ranking with the
host loop's stable tie-break, rolling-hash sequence dedup, parent gathers
of the KV cache and the token buffers).  The JAX package's native
window x beam batching (`decode_windows_native`, grouped selection) is not
ported.

The JAX package runs a window's token loop as one `lax.while_loop` per
attention-bucket segment.  Here one step function updates a LoopState of
tensors in place: logit filters, selection, timestamp and stop rules, the
KV cache and the token buffers, with the step index and every window input
as device tensors.  On the card each segment's step is one captured CUDA
graph, which the host replays step by step; it reads the "all lanes done"
flag once every FLAG_EVERY steps and the result buffers once per window.
On the CPU the same step runs eagerly, with the same flag reads.  Step i's
attention context comes from the same bucket segments as the JAX loop's;
the host picks the segment, since it counts the steps.

Every rule of the JAX loop is kept, including the n_max = n_text_ctx//2 - 4
cap and the denormal `tid` rule (_EXPF_ZERO_LP): a device that flushes
denormals would flip the reference's `sum(probs) > 0` test early, so the
test is made on the max timestamp logprob instead.

At t>0 lanes draw from a torch.Generator seeded with `rng_seed`; JAX's
PRNG bits cannot be reproduced, so t>0 agreement with the JAX package is
statistical.  At t=0 selection is argmax and exact.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.whisper import model as M
from ..models.whisper.hparams import CHUNK_SIZE, WhisperHParams
from .logits import LogitFilterTables

NEG_INF = float("-inf")
DELTA_MIN = 10


def build_masks(tables: LogitFilterTables, params) -> Tuple[np.ndarray, np.ndarray]:
    """(base_mask, initial_mask): additive {0,-inf} vectors folding all
    static token suppressions (src/whisper.cpp:6233-6310)."""
    v = tables.vocab
    n = max(v.id_to_token) + 1
    base = np.zeros(n, np.float32)
    base[v.token_not] = -np.inf
    base[v.token_sot] = -np.inf
    base[v.token_nosp] = -np.inf
    if not params.tdrz_enable:
        base[v.token_solm] = -np.inf
    base[v.token_translate] = -np.inf
    base[v.token_transcribe] = -np.inf
    base[v.token_prev] = -np.inf
    base[tables.lang_ids] = -np.inf
    if params.suppress_regex:
        base[tables.regex_ids(params.suppress_regex)] = -np.inf
    if params.suppress_nst:
        base[tables.nst_ids] = -np.inf
    if params.no_timestamps:
        base[v.token_beg:] = -np.inf

    initial = np.zeros(n, np.float32)
    if params.suppress_blank:
        initial[v.token_eot] = -np.inf
        if tables.space_id is not None:
            initial[tables.space_id] = -np.inf
    if params.max_initial_ts > 0.0:
        precision = float(CHUNK_SIZE) / tables.n_audio_ctx
        tid0 = int(round(params.max_initial_ts / precision))
        initial[v.token_beg + tid0 + 1:] = -np.inf
    return base, initial


class WindowResult(NamedTuple):
    """Per-lane results of one window attempt (numpy arrays)."""

    tok_id: np.ndarray
    tok_tid: np.ndarray
    tok_p: np.ndarray
    tok_plog: np.ndarray
    tok_pt: np.ndarray
    tok_ptsum: np.ndarray
    n_tok: np.ndarray
    result_len: np.ndarray
    seek_delta: np.ndarray
    has_ts: np.ndarray
    failed: np.ndarray
    completed: np.ndarray
    sum_logprobs: np.ndarray
    prompt_probs: np.ndarray      # (V,) softmax of raw prompt logits (no_speech)


def _apply_filters(raw, st_i, last_id, penult_id, has_ts, seek_delta,
                   base_mask, initial_mask, temperature, max_tokens, eot: int,
                   beg: int, no_timestamps: bool, single_segment: bool):
    """Vectorized whisper_process_logits over the lane axis.
    raw: (B, V); st_i, temperature and max_tokens are host numbers or 0-d
    device tensors (the captured step's form, the JAX package's traced
    ones).  Returns (logits, logprobs, probs)."""
    V = raw.shape[-1]
    dev = raw.device
    idx = torch.arange(V, device=dev)
    st_i, temperature, max_tokens = (torch.as_tensor(a, device=dev) for a in (
        st_i, temperature, max_tokens))

    # `where`, not a product with a 0/1 flag: 0 * -inf is NaN
    logits = torch.where(temperature > 0.0,
                         raw / torch.clamp(temperature, min=1e-9), raw)
    logits = logits + base_mask
    logits = torch.where(st_i == 0, logits + initial_mask, logits)

    # max_tokens rule (PR 3798): force ts/EOT once the cap is reached
    if not no_timestamps and not single_segment:
        cap = (max_tokens > 0) & (st_i >= max_tokens)
        logits = logits.masked_fill(cap & (idx < eot), NEG_INF)

    # timestamp pair rules (per-lane)
    last_was_ts = (st_i > 0) & (last_id >= beg)
    penult_was_ts = (st_i < 2) | (penult_id >= beg)
    ban_ts = (last_was_ts & penult_was_ts)[:, None] & (idx >= beg)[None, :]
    ban_text = (last_was_ts & ~penult_was_ts)[:, None] & (idx < eot)[None, :]
    logits = logits.masked_fill(ban_ts | ban_text, NEG_INF)

    # monotonic timestamps (per-lane seek_delta)
    tid0 = beg + torch.div(seek_delta, 2, rounding_mode="floor")
    mono = has_ts[:, None] & (idx[None, :] >= beg) & (idx[None, :] < tid0[:, None])
    logits = logits.masked_fill(mono, NEG_INF)

    logprobs = torch.log_softmax(logits, dim=-1)

    # sample-timestamp-iff rule: mask text when ts mass dominates
    is_ts_col = (idx >= beg)[None, :]
    ts_lse = torch.logsumexp(logprobs.masked_fill(~is_ts_col, NEG_INF), dim=-1)
    max_text = logprobs.masked_fill(is_ts_col, NEG_INF).amax(-1)
    force_ts = (ts_lse > max_text)[:, None] & ~is_ts_col
    logits = logits.masked_fill(force_ts, NEG_INF)
    logprobs = logprobs.masked_fill(force_ts, NEG_INF)

    probs = torch.where(torch.isneginf(logits), 0.0, torch.exp(logprobs))
    return logits, logprobs, probs


# expf underflows to +0.0 only below ln(2^-150) ~ -103.97: the reference's
# probs stay NONZERO through the f32 denormal range, but a device that
# flushes denormals to zero would flip a `sum(probs) > 0` test ~36 logprob
# units too early — the tid fallback is conditioned on the max timestamp
# LOGPROB instead (the JAX package's rule, kept as is).
_EXPF_ZERO_LP = -103.97


def _ts_has_mass(logprobs, idx, beg: int):
    ts_lp = logprobs.masked_fill((idx < beg)[None, :], NEG_INF)
    return ts_lp.amax(-1) > _EXPF_ZERO_LP


def _token_stats(probs, logprobs, tok, p, beg: int):
    """Timestamp stats (tid, pt, ptsum) for chosen tokens (the beam path's
    form: an all-suppressed row gives tid = beg)."""
    V = probs.shape[-1]
    idx = torch.arange(V, device=probs.device)
    ts_probs = probs.masked_fill((idx < beg)[None, :], 0.0)
    sum_ts = ts_probs.sum(-1)
    tid = ts_probs.argmax(-1)
    max_ts = ts_probs.gather(-1, tid[:, None])[:, 0]
    tid_lp = logprobs.masked_fill((idx < beg)[None, :], NEG_INF).argmax(-1)
    tid = torch.where(sum_ts > 0, tid, tid_lp)
    tid = torch.where(_ts_has_mass(logprobs, idx, beg), tid, beg)
    pt = max_ts / (sum_ts + 1e-10)
    is_ts_tok = tok >= beg
    return torch.where(is_ts_tok, tok, tid), torch.where(is_ts_tok, p, pt), sum_ts


def _sample(logprobs, probs, temperature: float, generator, beg: int):
    """whisper_sample_token: greedy at t=0, categorical at t>0 (the host
    float `temperature` picks the branch; `_apply_filters` already scaled
    the logits by the device value).  Returns per-lane (id, p, plog, tid,
    pt, ptsum)."""
    V = probs.shape[-1]
    idx = torch.arange(V, device=probs.device)
    if temperature < 1e-6:
        tok = probs.argmax(-1)
    else:
        # one categorical draw per lane as argmax(p / Exp(1)): what
        # torch.multinomial does for one sample, without its host-side
        # check of the probabilities, which a CUDA graph cannot capture
        q = torch.empty_like(probs).exponential_(1, generator=generator)
        tok = (probs / q).argmax(-1)
    p = probs.gather(-1, tok[:, None])[:, 0]
    plog = logprobs.gather(-1, tok[:, None])[:, 0]

    ts_probs = probs.masked_fill((idx < beg)[None, :], 0.0)
    sum_ts = ts_probs.sum(-1)
    tid = ts_probs.argmax(-1)
    max_ts = ts_probs.gather(-1, tid[:, None])[:, 0]
    # denormal regime: flushed probs tie at 0 — true argmax from logprobs
    tid_lp = logprobs.masked_fill((idx < beg)[None, :], NEG_INF).argmax(-1)
    tid = torch.where(sum_ts > 0, tid, tid_lp)
    # all-suppressed (no_timestamps): whisper_sample_token leaves tid at its
    # ZERO init (src/whisper.cpp:6489); the condition is the reference's
    # `probs[i] > 0` under expf's gradual underflow (_EXPF_ZERO_LP)
    tid = torch.where(_ts_has_mass(logprobs, idx, beg), tid, 0)
    pt = max_ts / (sum_ts + 1e-10)
    is_ts_tok = tok >= beg
    return (tok, p, plog, torch.where(is_ts_tok, tok, tid),
            torch.where(is_ts_tok, p, pt), sum_ts)


_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32), without int64 overflow:
    the JAX package's uint32 rolling-hash arithmetic."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _beam_select_core(logprobs, live, sum_logprobs, seq_hash, step_i, beg: int):
    """Device-side beam step (reference: src/whisper.cpp:7303-7354 and the
    host loop in full.py), as the JAX package's `_beam_select_core`.

    Each live beam proposes its top-B tokens (ties to the lower id, as
    lax.top_k); candidates rank by cumulative sequence logprob with the
    stable flattened (beam, k) tie-break, the host sort key (-score,
    decoder_idx); consecutive duplicate sequences (rolling hashes) are
    skipped when step_i > 0 (a host int or a 0-d device tensor); surplus
    beams wrap to the best candidate.  Returns (parent per beam, token,
    score, new hashes (B, 2))."""
    B = logprobs.shape[0]
    dev = logprobs.device
    vals, ids = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :B], ids[:, :B]                        # (B, B)
    cand_score = (sum_logprobs[:, None] + vals).masked_fill(~live[:, None], NEG_INF)
    h1 = (_mul32(seq_hash[:, 0:1], 1000003) + ids + 1) & _MASK32
    h2 = (_mul32(seq_hash[:, 1:2], 2654435761) + ids + 1) & _MASK32

    flat_score = cand_score.reshape(-1)
    flat_tok = ids.reshape(-1)
    flat_parent = torch.div(torch.arange(B * B, device=dev), B, rounding_mode="floor")
    flat_h1, flat_h2 = h1.reshape(-1), h2.reshape(-1)

    order = torch.argsort(-flat_score, stable=True)
    s_score = flat_score[order]
    s_h1, s_h2 = flat_h1[order], flat_h2[order]
    # consecutive-duplicate mask in sorted order (off at step 0)
    same = (s_h1[1:] == s_h1[:-1]) & (s_h2[1:] == s_h2[:-1])
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), same])
    dup = dup & (torch.as_tensor(step_i, device=dev) > 0)
    elig = ~dup & (s_score > NEG_INF)
    rank = torch.cumsum(elig.long(), 0) - 1
    total = torch.clamp(elig.long().sum(), min=1)

    # the m-th live beam takes the m-th eligible candidate; surplus beams
    # wrap to the best one (full.py's cur_c = 0)
    m = torch.where(live, torch.cumsum(live.long(), 0) - 1, 0) % total
    hit = (rank[None, :] == m[:, None]) & elig[None, :]        # (B, B*B)
    pick = order[hit.long().argmax(1)]
    src = torch.where(live, flat_parent[pick], torch.arange(B, device=dev))
    new_hash = torch.where(live[:, None],
                           torch.stack([flat_h1[pick], flat_h2[pick]], 1), seq_hash)
    return src, flat_tok[pick], flat_score[pick], new_hash


def _beam_select(logprobs, completed, failed, sum_logprobs, seq_hash, step_i,
                 beg: int):
    """Single-group wrapper over `_beam_select_core` (the one-window path):
    the live lanes are those neither completed nor failed."""
    return _beam_select_core(logprobs, ~(completed | failed), sum_logprobs,
                             seq_hash, step_i, beg)


# The host reads the "all lanes done" flag once every FLAG_EVERY steps.  A
# window that ends runs up to FLAG_EVERY - 1 more steps, which change no
# result (`live` masks every write) but cost a decode step each; a flag
# read costs far less than a step on the card, so a small period saves
# most readbacks for little overshoot (PERF.md §6 gives the measurements).
FLAG_EVERY = 4


def _planes(x):
    """The tensors of a cross-K/V operand: dense, or XK8 codes and scales."""
    return tuple(x) if isinstance(x, M.XK8) else (x,)


class LoopState:
    """The window loop's carried tensors (the JAX package's LoopState) and
    the window's inputs, each at one address for the state's life: the step
    updates them in place, so a CUDA graph captured over them replays window
    after window once `load` has put a window in."""

    def __init__(self, hp: WhisperHParams, B: int, n_max: int, cache_dtype,
                 kv_itype: str, xk, xv, n_mask: int, V: int, dev):
        def z(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i64, f32, b8 = torch.long, torch.float32, torch.bool
        self.cache = M.new_cache(hp, B, cache_dtype, itype=kv_itype, device=dev)
        self.xk, self.xv = (type(x)(*map(torch.zeros_like, x)) if isinstance(x, M.XK8)
                            else torch.zeros_like(x) for x in (xk, xv))
        self.base_mask, self.initial_mask = z(f32, n_mask), z(f32, n_mask)
        self.temperature = z(f32)
        self.seek, self.seek_end, self.max_tokens, self.prompt_len = (
            z(i64) for _ in range(4))
        self.i = z(i64)                          # step index
        self.done = z(b8)                        # every lane completed or failed
        self.logits_row = z(f32, B, V)           # raw logits feeding the next step
        self.last_id, self.penult_id = z(i64, B), z(i64, B)
        self.has_ts, self.failed, self.completed = z(b8, B), z(b8, B), z(b8, B)
        self.seek_delta, self.result_len, self.n_tok = z(i64, B), z(i64, B), z(i64, B)
        self.sum_logprobs = z(f32, B)
        self.seq_hash = z(i64, B, 2)             # rolling uint32 hashes (beam)
        self.tok_id, self.tok_tid = z(i64, B, n_max), z(i64, B, n_max)
        self.tok_p, self.tok_plog, self.tok_pt, self.tok_ptsum = (
            z(f32, B, n_max) for _ in range(4))
        self.gen = torch.Generator(device=dev)   # t>0 lanes' draws

    def buffers(self):
        """The per-column output buffers, in `_sample`'s order."""
        return (self.tok_id, self.tok_tid, self.tok_p, self.tok_plog,
                self.tok_pt, self.tok_ptsum)

    def load(self, cache1, last_row, xk, xv, base_mask, initial_mask,
             temperature: float, seek: int, seek_end: int, max_tokens: int,
             prompt_len: int, rng_seed: int) -> None:
        """Put a window in: the prompt pass's single-lane cache tiled over
        the lanes, its last logits row, the window's inputs; the carried
        state back to its start."""
        for dst, src in zip((*self.cache, *_planes(self.xk), *_planes(self.xv)),
                            (*cache1, *_planes(xk), *_planes(xv))):
            dst.copy_(src)
        self.base_mask.copy_(base_mask)
        self.initial_mask.copy_(initial_mask)
        self.logits_row.copy_(last_row)
        for t, v in ((self.temperature, temperature), (self.seek, seek),
                     (self.seek_end, seek_end), (self.max_tokens, max_tokens),
                     (self.prompt_len, prompt_len), (self.last_id, -1),
                     (self.penult_id, -1), (self.seek_delta, 100 * CHUNK_SIZE)):
            t.fill_(v)
        for t in (self.i, self.done, self.has_ts, self.failed, self.completed,
                  self.result_len, self.n_tok, self.sum_logprobs, self.seq_hash,
                  *self.buffers()):
            t.zero_()
        self.gen.manual_seed(int(rng_seed))

    def result(self, prompt_probs) -> WindowResult:
        """The window's one read of its result buffers."""
        return WindowResult(*(t.to("cpu", copy=True).numpy() for t in (
            *self.buffers(), self.n_tok, self.result_len, self.seek_delta,
            self.has_ts, self.failed, self.completed, self.sum_logprobs,
            prompt_probs)))


def make_window_decoder(hp: WhisperHParams, n_beams: int, prompt_bucket: int,
                        compute_dtype, no_timestamps: bool,
                        single_segment: bool, vocab_eot: int, vocab_beg: int,
                        kv_itype: str = "f16", strategy: str = "greedy"):
    """Build the whole-window decode function for one (lane count, prompt
    bucket, timestamp mode, strategy): "greedy" (greedy or best-of
    sampling lanes) or "beam" (beam search at t=0).

    On a CUDA tensor the window's steps replay CUDA graphs, one per
    attention-bucket segment and sampling branch, captured at first use
    over the decoder's LoopState; on a CPU tensor the same step runs
    eagerly.  `decode_window.eager` runs the eager loop on any device (a
    reference for the graphs on the card).  Counters on the returned
    function: `windows` (windows decoded), `readbacks` (host reads of the
    done flag, and one read of the results per window), `steps` (steps run,
    those past a window's end included), `graphs` (graphs captured) and
    `capture_us` (time spent warming up and capturing them)."""
    if strategy not in ("greedy", "beam"):
        raise ValueError(f"unknown window strategy {strategy!r}")
    n_max = hp.n_text_ctx // 2 - 4
    eot, beg = vocab_eot, vocab_beg
    B = n_beams
    cache_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    prompt_ctx = next(a for a in M.attn_ctx_buckets(hp.n_text_ctx)
                      if a >= prompt_bucket)
    # bucket segments reachable from this prompt bucket (JAX: one
    # while_loop per segment; segment a serves steps i < a - prompt_bucket)
    seg_sizes, entry = [], 0
    for a in M.attn_ctx_buckets(hp.n_text_ctx):
        if a <= prompt_bucket or entry >= n_max:
            continue
        seg_sizes.append(a)
        entry = a - prompt_bucket
    if not seg_sizes:
        seg_sizes = [hp.n_text_ctx]

    def step_ctx(i: int) -> int:
        for a in seg_sizes[:-1]:
            if i < a - prompt_bucket:
                return a
        return seg_sizes[-1]

    def step(st: LoopState, params, attn_ctx: int, temperature: float) -> None:
        """One token step over the state, in place (the JAX loop's body).
        `temperature` (host) picks the sampling branch only."""
        i = st.i
        live = ~(st.completed | st.failed)
        logits, logprobs, probs = _apply_filters(
            st.logits_row, i, st.last_id, st.penult_id, st.has_ts,
            st.seek_delta, st.base_mask, st.initial_mask, st.temperature,
            st.max_tokens, eot, beg, no_timestamps, single_segment)
        if strategy == "beam":
            # candidates, dedup, selection, then every per-lane state
            # follows its parent (the completed/failed flags stay per
            # slot, as in the JAX package); the cache is gathered into a
            # temporary and copied back to its one address
            src, tok, score, seq_hash = _beam_select(
                logprobs, st.completed, st.failed, st.sum_logprobs,
                st.seq_hash, i, beg)
            for a in st.cache:
                a.copy_(a.index_select(1, src))
            probs_g, logprobs_g = probs[src], logprobs[src]
            p = probs_g.gather(-1, tok[:, None])[:, 0]
            plog = logprobs_g.gather(-1, tok[:, None])[:, 0]
            tid, pt, ptsum = _token_stats(probs_g, logprobs_g, tok, p, beg)
            for a in (st.last_id, st.penult_id, st.has_ts, st.seek_delta,
                      st.result_len, st.n_tok, *st.buffers()):
                a.copy_(a[src])
            st.seq_hash.copy_(seq_hash)
            st.sum_logprobs.copy_(torch.where(live, score, st.sum_logprobs))
        else:
            tok, p, plog, tid, pt, ptsum = _sample(logprobs, probs, temperature,
                                                   st.gen, beg)
            st.sum_logprobs.copy_(torch.where(live, st.sum_logprobs + plog,
                                              st.sum_logprobs))

        # write buffers for live lanes at column i
        col = (torch.arange(n_max, device=i.device)[None, :] == i) & live[:, None]
        for buf, val in zip(st.buffers(), (tok, tid, p, plog, pt, ptsum)):
            buf.copy_(torch.where(col, val[:, None].to(buf.dtype), buf))
        st.n_tok.copy_(torch.where(live, i + 1, st.n_tok))

        # ---- state rules (src/whisper.cpp:7360-7443) ----
        is_ts = live & (tok > beg)
        sd_new = 2 * (tok - beg)
        fail_seek = is_ts & st.has_ts & (st.seek_delta > sd_new) & (st.result_len < i)
        ok_ts = is_ts & ~fail_seek
        seek_delta = torch.where(ok_ts, sd_new, st.seek_delta)
        result_len = torch.where(ok_ts, i + 1, st.result_len)
        has_ts = st.has_ts | ok_ts
        failed = st.failed | fail_seek

        still = live & ~fail_seek
        # end_window: the zero-result_len acceptance uses the BARE
        # window check (whisper.cpp:7409); only the completion clause
        # requires has_ts (:7406)
        end_window = st.seek + seek_delta + DELTA_MIN >= st.seek_end
        complete_cond = still & (
            (tok == eot) | (has_ts & end_window)
            | ((st.max_tokens > 0) & (i >= st.max_tokens)))
        if not no_timestamps:
            zero_len = complete_cond & (result_len == 0)
            result_len = torch.where(zero_len & end_window, i + 1, result_len)
            failed = failed | (zero_len & ~end_window)
            complete_cond = complete_cond & ~(zero_len & ~end_window)
        if single_segment or no_timestamps:
            result_len = torch.where(complete_cond, i + 1, result_len)
            seek_delta = torch.where(complete_cond, 100 * CHUNK_SIZE, seek_delta)
        completed = st.completed | complete_cond

        # repetition-loop failure on the last step
        failed = failed | ((i == n_max - 1) & still & ~complete_cond & (
            (result_len == 0) | (seek_delta < 100 * CHUNK_SIZE // 2)))

        last_id = torch.where(live, tok, st.last_id)
        st.penult_id.copy_(torch.where(live, st.last_id, st.penult_id))
        for dst, val in ((st.last_id, last_id), (st.seek_delta, seek_delta),
                         (st.result_len, result_len), (st.has_ts, has_ts),
                         (st.failed, failed), (st.completed, completed)):
            dst.copy_(val)
        st.done.copy_((completed | failed).all())

        # ---- next-token decode (batched over lanes) ----
        # every step decodes, as the JAX body does: a step after the last
        # lane has finished only writes what nothing reads
        n_past = st.prompt_len + i
        step_pos = torch.clamp(n_past, max=hp.n_text_ctx - 1).expand(B, 1)
        logits_next, _ = M.decode_step(
            params, tok[:, None], step_pos, n_past, st.cache, st.xk, st.xv, hp,
            dtype=compute_dtype, attn_ctx=attn_ctx)
        st.logits_row.copy_(logits_next[:, 0])
        st.i.add_(1)

    held = {"sig": None, "st": None, "graphs": {}, "pool": None}

    def state_for(params, xk, xv, base_mask, V: int, dev) -> LoopState:
        """The decoder's LoopState; a new one (and no graphs) when the
        weights, the device or a shape changes."""
        sig = (id(params), dev, V, tuple(base_mask.shape),
               tuple((tuple(t.shape), t.dtype) for t in (*_planes(xk), *_planes(xv))))
        if held["sig"] != sig:
            held.update(sig=sig, graphs={}, pool=None, st=LoopState(
                hp, B, n_max, cache_dtype, kv_itype, xk, xv, base_mask.shape[0],
                V, dev))
        return held["st"]

    def segment_graphs(st: LoopState, params, temperature: float):
        """{attn_ctx: graph} for the window's sampling branch, capturing the
        ones not captured yet (all segments at once, before the window is
        loaded: the warm-up step runs on the state)."""
        from . import graphs as G

        sampling = temperature >= 1e-6 and strategy == "greedy"
        graphs = held["graphs"]
        missing = [a for a in seg_sizes if (a, sampling) not in graphs]
        if missing:
            t0 = time.perf_counter()
            if held["pool"] is None:
                held["pool"] = torch.cuda.graph_pool_handle()
            for a in missing:
                graphs[(a, sampling)] = G.CountedGraph(
                    lambda a=a: step(st, params, a, temperature), held["pool"],
                    generator=st.gen if sampling else None)
            torch.cuda.synchronize(st.i.device)
            decode_window.capture_us += int((time.perf_counter() - t0) * 1e6)
            decode_window.graphs += len(missing)
        return {a: graphs[(a, sampling)] for a in seg_sizes}

    def run(params, prompt, prompt_len: int, xk, xv, base_mask, initial_mask,
            temperature: float, seek: int, seek_end: int, max_tokens: int,
            rng_seed: int, on_graphs: bool) -> WindowResult:
        dev = prompt.device
        # ---- prompt decode (single lane, eager: one per window) ----
        cache1 = M.new_cache(hp, 1, cache_dtype, itype=kv_itype, device=dev)
        pos = torch.clamp(torch.arange(prompt_bucket, device=dev), 0,
                          hp.n_text_ctx - 1)[None, :]
        logits_all, cache1 = M.decode_step(
            params, prompt[None, :], pos, 0, cache1, xk, xv, hp,
            dtype=compute_dtype, attn_ctx=prompt_ctx)
        last_row = logits_all[:, prompt_len - 1]                   # (1, V)
        prompt_probs = torch.softmax(last_row[0].float(), dim=-1)

        st = state_for(params, xk, xv, base_mask, last_row.shape[-1], dev)
        graphs = segment_graphs(st, params, temperature) if on_graphs else None
        st.load(cache1, last_row, xk, xv, base_mask, initial_mask, temperature,
                seek, seek_end, max_tokens, prompt_len, rng_seed)
        # the host counts the steps, so it picks each step's segment and
        # stops at n_max itself; it reads the done flag every FLAG_EVERY
        # steps (JAX: the while_loop's cond, on the device)
        i = 0
        while i < n_max:
            if on_graphs:
                graphs[step_ctx(i)].replay()
            else:
                step(st, params, step_ctx(i), temperature)
            i += 1
            if i % FLAG_EVERY == 0 and i < n_max:
                decode_window.readbacks += 1
                if bool(st.done):
                    break
        decode_window.windows += 1
        decode_window.steps += i
        decode_window.readbacks += 1
        return st.result(prompt_probs)

    def decode_window(params, prompt, prompt_len: int, xk, xv, base_mask,
                      initial_mask, temperature: float, seek: int,
                      seek_end: int, max_tokens: int, rng_seed: int) -> WindowResult:
        return run(params, prompt, prompt_len, xk, xv, base_mask, initial_mask,
                   temperature, seek, seek_end, max_tokens, rng_seed,
                   on_graphs=prompt.device.type == "cuda")

    decode_window.eager = functools.partial(run, on_graphs=False)
    decode_window.windows = decode_window.readbacks = decode_window.steps = 0
    decode_window.graphs = decode_window.capture_us = 0
    return decode_window
