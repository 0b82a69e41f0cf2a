"""Window decoding with the token-loop state resident on the device.

Port of whisper_tpu/decoding/device_loop.py for the GREEDY strategy (one
lane at t=0; `best_of` independent sampling lanes at t>0) and BEAM SEARCH at
t=0 (deterministic top-k candidates, cumulative-logprob ranking with the
host loop's stable tie-break, rolling-hash sequence dedup, parent gathers
of the KV cache and the token buffers).  The JAX package's native
window x beam batching (`decode_windows_native`, grouped selection) is not
ported.  The JAX package
runs the whole window inside one `lax.while_loop`; here a host loop drives
one device-resident state: logit filters, selection, timestamp and stop
rules, the KV cache and the token buffers stay tensors on the device, and
the host reads ONE flag per step (all lanes done?) plus the result buffers
once per window.  Step i's attention context comes from the same bucket
segments as the JAX loop (`make_window_decoder` segment sizes), chosen on
the host because i is a host integer here.

Every rule of the JAX loop is kept, including the n_max = n_text_ctx//2 - 4
cap and the denormal `tid` rule (_EXPF_ZERO_LP): a device that flushes
denormals would flip the reference's `sum(probs) > 0` test early, so the
test is made on the max timestamp logprob instead.

At t>0 lanes draw from a torch.Generator seeded with `rng_seed`; JAX's
PRNG bits cannot be reproduced, so t>0 agreement with the JAX package is
statistical.  At t=0 selection is argmax and exact.
"""

from __future__ import annotations

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


def _apply_filters(raw, st_i: int, last_id, penult_id, has_ts, seek_delta,
                   base_mask, initial_mask, temperature: float,
                   max_tokens: int, eot: int, beg: int, no_timestamps: bool,
                   single_segment: bool):
    """Vectorized whisper_process_logits over the lane axis.
    raw: (B, V); returns (logits, logprobs, probs)."""
    V = raw.shape[-1]
    idx = torch.arange(V, device=raw.device)

    logits = raw / max(temperature, 1e-9) if temperature > 0.0 else raw
    logits = logits + base_mask
    if st_i == 0:
        logits = logits + initial_mask

    # max_tokens rule (PR 3798): force ts/EOT once the cap is reached
    if not no_timestamps and not single_segment and 0 < max_tokens <= st_i:
        logits = logits.masked_fill(idx < eot, NEG_INF)

    # timestamp pair rules (per-lane)
    last_was_ts = (last_id >= beg) if st_i > 0 else torch.zeros_like(has_ts)
    penult_was_ts = (penult_id >= beg) if st_i >= 2 else torch.ones_like(has_ts)
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
    """whisper_sample_token: greedy at t=0, categorical at t>0.
    Returns per-lane (id, p, plog, tid, pt, ptsum)."""
    V = probs.shape[-1]
    idx = torch.arange(V, device=probs.device)
    if temperature < 1e-6:
        tok = probs.argmax(-1)
    else:
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
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


def _beam_select_core(logprobs, live, sum_logprobs, seq_hash, step_i: int,
                      beg: int):
    """Device-side beam step (reference: src/whisper.cpp:7303-7354 and the
    host loop in full.py), as the JAX package's `_beam_select_core`.

    Each live beam proposes its top-B tokens (ties to the lower id, as
    lax.top_k); candidates rank by cumulative sequence logprob with the
    stable flattened (beam, k) tie-break, the host sort key (-score,
    decoder_idx); consecutive duplicate sequences (rolling hashes) are
    skipped when step_i > 0; surplus beams wrap to the best candidate.
    Returns (parent per beam, token, score, new hashes (B, 2))."""
    B = logprobs.shape[0]
    dev = logprobs.device
    vals, ids = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :B], ids[:, :B]                        # (B, B)
    cand_score = (sum_logprobs[:, None] + vals).masked_fill(~live[:, None], NEG_INF)
    h1 = (_mul32(seq_hash[:, 0:1], 1000003) + ids + 1) & _MASK32
    h2 = (_mul32(seq_hash[:, 1:2], 2654435761) + ids + 1) & _MASK32

    flat_score = cand_score.reshape(-1)
    flat_tok = ids.reshape(-1)
    flat_parent = torch.arange(B, device=dev).repeat_interleave(B)
    flat_h1, flat_h2 = h1.reshape(-1), h2.reshape(-1)

    order = torch.argsort(-flat_score, stable=True)
    s_score = flat_score[order]
    s_h1, s_h2 = flat_h1[order], flat_h2[order]
    # consecutive-duplicate mask in sorted order (off at step 0)
    dup = torch.zeros(B * B, dtype=torch.bool, device=dev)
    if step_i > 0:
        dup[1:] = (s_h1[1:] == s_h1[:-1]) & (s_h2[1:] == s_h2[:-1])
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


def _beam_select(logprobs, completed, failed, sum_logprobs, seq_hash, step_i: int,
                 beg: int):
    """Single-group wrapper over `_beam_select_core` (the one-window path):
    the live lanes are those neither completed nor failed."""
    return _beam_select_core(logprobs, ~(completed | failed), sum_logprobs,
                             seq_hash, step_i, beg)


def make_window_decoder(hp: WhisperHParams, n_beams: int, prompt_bucket: int,
                        compute_dtype, no_timestamps: bool,
                        single_segment: bool, vocab_eot: int, vocab_beg: int,
                        kv_itype: str = "f16", strategy: str = "greedy"):
    """Build the whole-window decode function for one (lane count, prompt
    bucket, timestamp mode, strategy): "greedy" (greedy or best-of
    sampling lanes) or "beam" (beam search at t=0).  `readbacks` on the
    returned function counts the host reads of device flags."""
    if strategy not in ("greedy", "beam"):
        raise ValueError(f"unknown window strategy {strategy!r}")
    n_max = hp.n_text_ctx // 2 - 4
    eot, beg = vocab_eot, vocab_beg
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

    def decode_window(params, prompt, prompt_len: int, xk, xv, base_mask,
                      initial_mask, temperature: float, seek: int,
                      seek_end: int, max_tokens: int, rng_seed: int) -> WindowResult:
        B = n_beams
        dev = prompt.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng_seed))

        # ---- prompt decode (single lane), then tile KV across lanes ----
        cache1 = M.new_cache(hp, 1, cache_dtype, itype=kv_itype, device=dev)
        pos = torch.clamp(torch.arange(prompt_bucket, device=dev), 0,
                          hp.n_text_ctx - 1)[None, :]
        logits_all, cache1 = M.decode_step(
            params, prompt[None, :], pos, 0, cache1, xk, xv, hp,
            dtype=compute_dtype, attn_ctx=prompt_ctx)
        last_row = logits_all[:, prompt_len - 1]                   # (1, V)
        prompt_probs = torch.softmax(last_row[0].float(), dim=-1)
        cache = type(cache1)(*(a.repeat(1, B, *([1] * (a.ndim - 2)))
                               for a in cache1))

        def zeros(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        logits_row = last_row.repeat(B, 1)
        last_id = torch.full((B,), -1, dtype=torch.long, device=dev)
        penult_id = last_id.clone()
        has_ts = zeros(torch.bool, B)
        seek_delta = torch.full((B,), 100 * CHUNK_SIZE, dtype=torch.long, device=dev)
        result_len = zeros(torch.long, B)
        failed = zeros(torch.bool, B)
        completed = zeros(torch.bool, B)
        sum_logprobs = zeros(torch.float32, B)
        tok_id, tok_tid = zeros(torch.long, B, n_max), zeros(torch.long, B, n_max)
        tok_p, tok_plog, tok_pt, tok_ptsum = (zeros(torch.float32, B, n_max)
                                              for _ in range(4))
        n_tok = zeros(torch.long, B)
        seq_hash = zeros(torch.long, B, 2)       # rolling uint32 hashes (beam)

        for i in range(n_max):
            live = ~(completed | failed)
            logits, logprobs, probs = _apply_filters(
                logits_row, i, last_id, penult_id, has_ts, seek_delta,
                base_mask, initial_mask, temperature, max_tokens, eot, beg,
                no_timestamps, single_segment)
            if strategy == "beam":
                # candidates, dedup, selection, then every per-lane state
                # follows its parent (the completed/failed flags stay per
                # slot, as in the JAX package)
                src, tok, score, seq_hash = _beam_select(
                    logprobs, completed, failed, sum_logprobs, seq_hash, i, beg)
                cache = cache.reorder(src)
                probs_g, logprobs_g = probs[src], logprobs[src]
                p = probs_g.gather(-1, tok[:, None])[:, 0]
                plog = logprobs_g.gather(-1, tok[:, None])[:, 0]
                tid, pt, ptsum = _token_stats(probs_g, logprobs_g, tok, p, beg)
                last_id, penult_id, has_ts, seek_delta, result_len, n_tok = (
                    a[src] for a in (last_id, penult_id, has_ts, seek_delta,
                                     result_len, n_tok))
                tok_id, tok_tid, tok_p, tok_plog, tok_pt, tok_ptsum = (
                    a[src] for a in (tok_id, tok_tid, tok_p, tok_plog, tok_pt,
                                     tok_ptsum))
                sum_logprobs = torch.where(live, score, sum_logprobs)
            else:
                tok, p, plog, tid, pt, ptsum = _sample(logprobs, probs,
                                                       temperature, gen, beg)
                sum_logprobs = torch.where(live, sum_logprobs + plog, sum_logprobs)

            # write buffers for live lanes at column i
            for buf, val in ((tok_id, tok), (tok_tid, tid), (tok_p, p),
                             (tok_plog, plog), (tok_pt, pt), (tok_ptsum, ptsum)):
                buf[:, i] = torch.where(live, val.to(buf.dtype), buf[:, i])
            n_tok = torch.where(live, i + 1, n_tok)

            # ---- state rules (src/whisper.cpp:7360-7443) ----
            is_ts = live & (tok > beg)
            sd_new = 2 * (tok - beg)
            fail_seek = is_ts & has_ts & (seek_delta > sd_new) & (result_len < i)
            ok_ts = is_ts & ~fail_seek
            seek_delta = torch.where(ok_ts, sd_new, seek_delta)
            result_len = torch.where(ok_ts, i + 1, result_len)
            has_ts = has_ts | ok_ts
            failed = failed | fail_seek

            still = live & ~fail_seek
            # end_window: the zero-result_len acceptance uses the BARE
            # window check (whisper.cpp:7409); only the completion clause
            # requires has_ts (:7406)
            end_window = seek + seek_delta + DELTA_MIN >= seek_end
            complete_cond = still & (
                (tok == eot) | (has_ts & end_window)
                | bool(max_tokens > 0 and i >= max_tokens))
            if not no_timestamps:
                zero_len = complete_cond & (result_len == 0)
                result_len = torch.where(zero_len & end_window, i + 1, result_len)
                failed = failed | (zero_len & ~end_window)
                complete_cond = complete_cond & ~(zero_len & ~end_window)
            if single_segment or no_timestamps:
                result_len = torch.where(complete_cond, i + 1, result_len)
                seek_delta = torch.where(complete_cond, 100 * CHUNK_SIZE, seek_delta)
            completed = completed | complete_cond

            # repetition-loop failure on the last step
            if i == n_max - 1:
                failed = failed | (still & ~complete_cond & (
                    (result_len == 0) | (seek_delta < 100 * CHUNK_SIZE // 2)))

            penult_id = torch.where(live, last_id, penult_id)
            last_id = torch.where(live, tok, last_id)
            # the loop's one readback per step; a finished window skips the
            # next-token decode, whose logits nothing would read
            decode_window.readbacks += 1
            if i == n_max - 1 or bool((completed | failed).all()):
                break

            # ---- next-token decode (batched over lanes) ----
            n_past = prompt_len + i
            step_pos = torch.full((B, 1), min(n_past, hp.n_text_ctx - 1),
                                  dtype=torch.long, device=dev)
            logits_next, cache = M.decode_step(
                params, tok[:, None], step_pos, n_past, cache, xk, xv, hp,
                dtype=compute_dtype, attn_ctx=step_ctx(i))
            logits_row = logits_next[:, 0]

        host = [t.cpu().numpy() for t in (
            tok_id, tok_tid, tok_p, tok_plog, tok_pt, tok_ptsum, n_tok,
            result_len, seek_delta, has_ts, failed, completed, sum_logprobs,
            prompt_probs)]
        decode_window.readbacks += 1
        return WindowResult(*host)

    decode_window.readbacks = 0
    return decode_window
