"""Window decoding with the token-loop state resident on the device.

Port of whisper_tpu/decoding/device_loop.py: the GREEDY strategy (one lane
at t=0; `best_of` independent sampling lanes at t>0) and BEAM SEARCH at
t=0 (deterministic top-k candidates, cumulative-logprob ranking with the
host loop's stable tie-break, rolling-hash sequence dedup, parent gathers
of the KV cache and the token buffers), for one window or, natively
batched, for W windows at once (`make_window_decoder(n_windows=W)`, the
JAX package's `decode_windows_native`): W windows x G lanes ride the
decoder's row axis, prompts left-padded to the bucket so the cache keeps
one write head, with per-row positions, an additive pad mask, grouped
beam selection (`_beam_select_grouped`) and each window's cross-K/V shared
by its lanes (`decode_step(xkv_group=G)`).  The JAX package's vmapped
window mode is not ported (the batcher never takes it).

The JAX package runs a window's token loop as one `lax.while_loop` per
attention-bucket segment.  Here one step function updates a LoopState of
tensors in place: logit filters, selection, timestamp and stop rules, the
KV cache and the token buffers, with the step index and every window input
as device tensors.  On the card each segment's step is one captured CUDA
graph, which the host replays step by step; it reads the "all lanes done"
flag once every FLAG_EVERY steps and the result buffers once per call.
On the CPU the same step runs eagerly, with the same flag reads.  Step i's
attention context comes from the same bucket segments as the JAX loop's;
the host picks the segment, since it counts the steps.

Every rule of the JAX loop is kept, including the n_max = n_text_ctx//2 - 4
cap and the denormal `tid` rule (_EXPF_ZERO_LP): a device that flushes
denormals would flip the reference's `sum(probs) > 0` test early, so the
test is made on the max timestamp logprob instead.

At t>0 each window's lanes draw from a torch.Generator of that window,
seeded with its `rng_seed`, so a window draws the same numbers batched or
solo, whatever shares its batch.  JAX's PRNG bits cannot be reproduced,
so t>0 agreement with the JAX package is statistical.  At t=0 selection is
argmax and exact.

`parity=True` decodes in the ggml-CPU parity mode (models/whisper/model.py
`decode_step(parity)`): an f16 cache, one more dtype at its one address,
and every prompt pass, capture and eager step inside graphs.full_f32.

`tp=` (a tensor-parallel process group, parallel/mesh.py) runs every
decode_step on the rank's H/tp heads with its caches and cross-K/V cut
the same way.  Sampling, the filters and beam selection run on every rank
alike: after the last all-reduce every rank holds the same logits, and
the same seeded generators draw the same numbers, so the ranks choose the
same tokens with no broadcast.  NCCL's collectives are captured into the
segment graphs with the rest of the step; gloo's run on the host and
cannot be, so under a gloo group the decoder runs its eager loop on the
card too.  The group's backend decides, and the choice shows in the
`eager_windows` counter and is logged once.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.whisper import model as M
from ..models.whisper.hparams import CHUNK_SIZE, WhisperHParams
from ..runtime.logging import log_info
from . import graphs as CG
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


def _sample(logprobs, probs, temperature: float, generators, beg: int,
            row_temp=None):
    """whisper_sample_token: greedy at t=0, categorical at t>0 (the host
    float `temperature` picks the branch; `_apply_filters` already scaled
    the logits by the device values).  At t>0 the rows are windows of equal
    lane counts, window-major: window w's lanes draw from `generators[w]`,
    and rows whose `row_temp` (device, (B,)) is 0 keep the argmax.  Returns
    per-lane (id, p, plog, tid, pt, ptsum)."""
    V = probs.shape[-1]
    idx = torch.arange(V, device=probs.device)
    if temperature < 1e-6:
        tok = probs.argmax(-1)
    else:
        # one categorical draw per lane as argmax(p / Exp(1)): what
        # torch.multinomial does for one sample, without its host-side
        # check of the probabilities, which a CUDA graph cannot capture
        draws = [torch.empty((probs.shape[0] // len(generators), V), dtype=probs.dtype,
                             device=probs.device).exponential_(1, generator=g)
                 for g in generators]
        q = draws[0] if len(draws) == 1 else torch.cat(draws)
        tok = torch.where(row_temp < 1e-6, probs.argmax(-1), (probs / q).argmax(-1))
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
    host loop in full.py), as the JAX package's `_beam_select_core`, over
    one group of B beams, (B, V), or a leading axis of N independent
    groups, (N, B, V).

    Each live beam proposes its top-B tokens (ties to the lower id, as
    lax.top_k); candidates rank by cumulative sequence logprob with the
    stable flattened (beam, k) tie-break, the host sort key (-score,
    decoder_idx); consecutive duplicate sequences (rolling hashes) are
    skipped when step_i > 0 (a host int or a 0-d device tensor); surplus
    beams wrap to the best candidate.  Returns (parent per beam within its
    group, token, score, new hashes (..., B, 2))."""
    if logprobs.dim() == 2:
        return tuple(a[0] for a in _beam_select_core(
            logprobs[None], live[None], sum_logprobs[None], seq_hash[None],
            step_i, beg))
    N, B = logprobs.shape[:2]
    dev = logprobs.device
    vals, ids = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    vals, ids = vals[..., :B], ids[..., :B]                       # (N, B, B)
    cand_score = (sum_logprobs[..., None] + vals).masked_fill(~live[..., None], NEG_INF)
    h1 = (_mul32(seq_hash[..., 0:1], 1000003) + ids + 1) & _MASK32
    h2 = (_mul32(seq_hash[..., 1:2], 2654435761) + ids + 1) & _MASK32

    flat_score = cand_score.reshape(N, B * B)
    flat_tok = ids.reshape(N, B * B)
    flat_parent = torch.div(torch.arange(B * B, device=dev), B,
                            rounding_mode="floor").expand(N, B * B)
    flat_h1, flat_h2 = h1.reshape(N, B * B), h2.reshape(N, B * B)

    order = torch.argsort(-flat_score, dim=-1, stable=True)
    s_score = flat_score.gather(1, order)
    s_h1, s_h2 = flat_h1.gather(1, order), flat_h2.gather(1, order)
    # consecutive-duplicate mask in sorted order (off at step 0)
    same = (s_h1[:, 1:] == s_h1[:, :-1]) & (s_h2[:, 1:] == s_h2[:, :-1])
    dup = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=dev), same], 1)
    dup = dup & (torch.as_tensor(step_i, device=dev) > 0)
    elig = ~dup & (s_score > NEG_INF)
    rank = torch.cumsum(elig.long(), 1) - 1
    total = torch.clamp(elig.long().sum(1, keepdim=True), min=1)

    # the m-th live beam takes the m-th eligible candidate; surplus beams
    # wrap to the best one (full.py's cur_c = 0)
    m = torch.where(live, torch.cumsum(live.long(), 1) - 1, 0) % total
    hit = (rank[:, None, :] == m[:, :, None]) & elig[:, None, :]   # (N, B, B*B)
    pick = order.gather(1, hit.long().argmax(2))
    src = torch.where(live, flat_parent.gather(1, pick), torch.arange(B, device=dev))
    new_hash = torch.where(live[..., None],
                           torch.stack([flat_h1.gather(1, pick),
                                        flat_h2.gather(1, pick)], -1), seq_hash)
    return src, flat_tok.gather(1, pick), flat_score.gather(1, pick), new_hash


def _beam_select_grouped(logprobs, completed, failed, sum_logprobs, seq_hash,
                         step_i, beg: int, n_groups: int, group: int):
    """Grouped beam step of native window x beam batching (the JAX
    package's `_beam_select_grouped`): rows are `n_groups` windows of
    `group` lanes, window-major; selection runs inside each group, and the
    parents come back GLOBAL (w * group + local), so the gathers of the
    cache and the state stay flat on the row axis."""
    def resh(a):
        return a.reshape(n_groups, group, *a.shape[1:])

    src, tok, score, new_hash = _beam_select_core(
        resh(logprobs), resh(~(completed | failed)), resh(sum_logprobs),
        resh(seq_hash), step_i, beg)
    offs = (torch.arange(n_groups, device=logprobs.device) * group)[:, None]
    return ((src + offs).reshape(-1), tok.reshape(-1), score.reshape(-1),
            new_hash.reshape(-1, 2))


# The host reads the "all lanes done" flag once every FLAG_EVERY steps.  A
# window that ends runs up to FLAG_EVERY - 1 more steps, which change no
# result (`live` masks every write) but cost a decode step each; a flag
# read costs far less than a step on the card, so a small period saves
# most readbacks for little overshoot (PERF.md §6 gives the measurements).
FLAG_EVERY = 4


def _planes(x):
    """The tensors of a cross-K/V operand: dense, or XK8 codes and scales."""
    return tuple(x) if isinstance(x, M.XK8) else (x,)


def _map_planes(fn, x):
    """`fn` over every tensor of a cross-K/V operand, keeping its form."""
    return M.XK8(*map(fn, x)) if isinstance(x, M.XK8) else fn(x)


def prompt_pad_masks(prompt_bucket: int, n_cells: int, prompt_lens, dev):
    """The left-pad layout of W natively batched prompts: (cell c's token
    index c - shift_w in row w (W, bucket), the prompt pass's additive mask
    (W, 1, bucket, C), the steps' additive mask (W, 1, 1, C)).  Cells below
    shift_w = bucket - len_w are pad and stay hidden for the whole window."""
    shift = prompt_bucket - torch.tensor(prompt_lens, device=dev)       # (W,)
    cells = torch.arange(prompt_bucket, device=dev)[None, :] - shift[:, None]
    c = torch.arange(n_cells, device=dev)
    is_pad = c[None, :] < shift[:, None]                                # (W, C)
    # a pad QUERY would see an all-masked row (softmax NaN in the cache):
    # each pad query sees itself; its output is never read
    diag = c[:prompt_bucket, None] == c[None, :]
    mask_prompt = torch.where(is_pad[:, None, :] & ~diag[None], NEG_INF,
                              0.0)[:, None]
    return cells, mask_prompt, torch.where(is_pad, NEG_INF, 0.0)[:, None, None, :]


class LoopState:
    """The window loop's carried tensors (the JAX package's LoopState) and
    the inputs of its W windows, each at one address for the state's life:
    the step updates them in place, so a CUDA graph captured over them
    replays call after call once `load` has put the windows in.  Rows are W
    windows of G lanes, window-major."""

    def __init__(self, hp: WhisperHParams, W: int, G: int, n_max: int,
                 n_cells: int, cache_dtype, kv_itype: str, xk, xv, n_mask: int,
                 V: int, dev, tp=None):
        def z(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i64, f32, b8 = torch.long, torch.float32, torch.bool
        R = W * G
        self.W, self.G = W, G
        self.cache = M.new_cache(hp, R, cache_dtype, itype=kv_itype, device=dev,
                                 n_cells=n_cells, tp=tp)
        # one window's cross-K/V (L, H, Tc, d), or W windows' (L, W, H, Tc, d)
        self.xk, self.xv = (_map_planes(lambda a: z(a.dtype, *a.shape), x)
                            for x in (xk, xv))
        self.base_mask, self.initial_mask = z(f32, n_mask), z(f32, n_mask)
        self.temperature = z(f32, R, 1)
        self.seek, self.seek_end = z(i64, R), z(i64, R)
        self.max_tokens = z(i64)
        self.head = z(i64)                       # the cache cell step 0 writes
        self.pos0 = z(i64, R)                    # the position of step 0's token
        # the left-pad cells of a batched window's rows, masked
        self.attn_mask = z(f32, R, 1, 1, n_cells) if W > 1 else None
        self.i = z(i64)                          # step index
        self.done = z(b8)                        # every lane completed or failed
        self.logits_row = z(f32, R, V)           # raw logits feeding the next step
        self.last_id, self.penult_id = z(i64, R), z(i64, R)
        self.has_ts, self.failed, self.completed = z(b8, R), z(b8, R), z(b8, R)
        self.seek_delta, self.result_len, self.n_tok = z(i64, R), z(i64, R), z(i64, R)
        self.sum_logprobs = z(f32, R)
        self.seq_hash = z(i64, R, 2)             # rolling uint32 hashes (beam)
        self.tok_id, self.tok_tid = z(i64, R, n_max), z(i64, R, n_max)
        self.tok_p, self.tok_plog, self.tok_pt, self.tok_ptsum = (
            z(f32, R, n_max) for _ in range(4))
        # t>0 lanes' draws: one generator per window
        self.gens = [torch.Generator(device=dev) for _ in range(W)]

    def buffers(self):
        """The per-column output buffers, in `_sample`'s order."""
        return (self.tok_id, self.tok_tid, self.tok_p, self.tok_plog,
                self.tok_pt, self.tok_ptsum)

    def load(self, cache_w, last_rows, xk, xv, base_mask, initial_mask,
             temperatures, seeks, seek_ends, max_tokens: int, head: int, pos0,
             rng_seeds, attn_mask=None) -> None:
        """Put the W windows in: the prompt pass's cache rows and last logits
        rows (one per window) repeated over each window's G lanes, the
        windows' inputs (sequences of W host numbers for the per-window
        ones), and the carried state back to its start."""
        W, G = self.W, self.G
        for dst, src in zip(self.cache, cache_w):
            dst.unflatten(1, (W, G)).copy_(src.unsqueeze(2))
        for dst, src in zip((*_planes(self.xk), *_planes(self.xv)),
                            (*_planes(xk), *_planes(xv))):
            dst.copy_(src)
        self.logits_row.unflatten(0, (W, G)).copy_(last_rows.unsqueeze(1))
        if attn_mask is not None:
            self.attn_mask.unflatten(0, (W, G)).copy_(attn_mask.unsqueeze(1))
        self.base_mask.copy_(base_mask)
        self.initial_mask.copy_(initial_mask)
        for t, vals in ((self.temperature, temperatures), (self.seek, seeks),
                        (self.seek_end, seek_ends), (self.pos0, pos0)):
            t.view(W, G).copy_(torch.tensor(vals, dtype=t.dtype, device=t.device)[:, None])
        for t, v in ((self.max_tokens, max_tokens), (self.head, head),
                     (self.last_id, -1), (self.penult_id, -1),
                     (self.seek_delta, 100 * CHUNK_SIZE)):
            t.fill_(v)
        for t in (self.i, self.done, self.has_ts, self.failed, self.completed,
                  self.result_len, self.n_tok, self.sum_logprobs, self.seq_hash,
                  *self.buffers()):
            t.zero_()
        for g, seed in zip(self.gens, rng_seeds):
            g.manual_seed(int(seed))

    def result(self, prompt_probs) -> WindowResult:
        """The one read of the result buffers; with W > 1 windows every
        per-lane field comes back as (W, G, ...) and prompt_probs as (W, V)."""
        out = [t.to("cpu", copy=True).numpy() for t in (
            *self.buffers(), self.n_tok, self.result_len, self.seek_delta,
            self.has_ts, self.failed, self.completed, self.sum_logprobs)]
        if self.W > 1:
            out = [a.reshape(self.W, self.G, *a.shape[1:]) for a in out]
        return WindowResult(*out, prompt_probs.to("cpu", copy=True).numpy())


def make_window_decoder(hp: WhisperHParams, n_beams: int, prompt_bucket: int,
                        compute_dtype, no_timestamps: bool,
                        single_segment: bool, vocab_eot: int, vocab_beg: int,
                        vmap_windows: bool = False, kv_itype: str = "f16",
                        strategy: str = "greedy", n_windows: int = 1,
                        parity: bool = False, tp=None):
    """Build the whole-window decode function for one (lane count, prompt
    bucket, timestamp mode, strategy, window count): "greedy" (greedy or
    best-of sampling lanes) or "beam" (beam search at t=0).

    vmap_windows (with n_windows = 1) is the JAX package's vmapped mode: the
    function takes the per-window arguments stacked on a leading window axis,
    as its `in_axes` do (prompt (W, bucket), prompt_len, xk, xv (W, L, ...),
    temperature, seek, seek_end and rng_seed, each W long; the masks and
    max_tokens shared), decodes each window as the one-window decoder does,
    in turn, and returns every field as (W, ...).  The native mode
    (n_windows = W) batches the windows' rows into one decode instead and
    takes precedence, as in the JAX package.  vmap_windows is reference-only,
    kept for parity with the JAX surface: no caller of the port selects it
    (the native mode is the batched path).

    n_windows = W > 1 is the JAX package's native window batching
    (`decode_windows_native`): W windows x n_beams lanes on one row axis,
    window-major.  Its per-window arguments come stacked, as the JAX
    package's: prompts (W, bucket) right-padded, xk/xv (W, L, H, Tc, d) (or
    XK8 planes stacked so), and sequences of W host numbers for prompt_len,
    temperature, seek, seek_end and rng_seed; base/initial masks and
    max_tokens are shared.  Prompts are LEFT-padded to the bucket, so every
    row's last prompt cell is bucket - 1 and step i writes cell bucket + i
    for all rows; each row has its own positions and an additive mask over
    its pad cells.  Result fields are (W, n_beams, ...), prompt_probs (W, V).

    parity: the ggml-CPU parity mode (compute_dtype f16, an f16 cache),
    as the JAX package's `make_window_decoder(parity=True)`.

    tp: a tensor-parallel process group; params, xk and xv are this rank's
    part (module docstring).  Under a group whose backend is not NCCL the
    card runs the eager loop (the collectives cannot be captured).

    On a CUDA tensor the steps replay CUDA graphs, one per attention-bucket
    segment and sampling branch, captured at first use over the decoder's
    LoopState; on a CPU tensor the same step runs eagerly.
    `decode_window.eager` runs the eager loop on any device (a reference
    for the graphs on the card).  Every call holds graphs.DEVICE_LOCK.
    Counters on the returned function: `windows` (windows decoded),
    `readbacks` (host reads of the done flag, and one read of the results
    per call), `steps` (steps run, those past the windows' end included),
    `graphs` (graphs captured), `capture_us` (time spent warming up and
    capturing them) and `eager_windows` (windows decoded on the eager loop:
    on the CPU, through `.eager`, or on the card under a non-NCCL tp
    group)."""
    if strategy not in ("greedy", "beam"):
        raise ValueError(f"unknown window strategy {strategy!r}")
    # collectives over NCCL can be captured into the segment graphs; gloo's
    # run on the host
    graphs_ok = tp is None or torch.distributed.get_backend(tp) == "nccl"
    n_max = hp.n_text_ctx // 2 - 4
    eot, beg = vocab_eot, vocab_beg
    W, G = n_windows, n_beams
    native = W > 1
    cache_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    if parity:
        cache_dtype = torch.float16
    numerics = CG.full_f32 if parity else contextlib.nullcontext
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
    n_cells = hp.n_text_ctx
    if native:
        # step i writes cell prompt_bucket + i, so the batch needs
        # prompt_bucket + n_max cells, which can pass n_text_ctx (JAX:
        # n_cells_native, seg_sizes_native)
        n_cells = max(hp.n_text_ctx, prompt_bucket + n_max)
        seg_sizes = [a for a in seg_sizes if a < n_cells]
        if not seg_sizes or seg_sizes[-1] - prompt_bucket < n_max:
            seg_sizes.append(n_cells)

    def step_ctx(i: int) -> int:
        for a in seg_sizes[:-1]:
            if i < a - prompt_bucket:
                return a
        return seg_sizes[-1]

    def step(st: LoopState, params, attn_ctx: int, temperature: float) -> None:
        """One token step over the state, in place (the JAX loop's body).
        `temperature` (host, the largest of the windows') picks the
        sampling branch only."""
        i = st.i
        live = ~(st.completed | st.failed)
        logits, logprobs, probs = _apply_filters(
            st.logits_row, i, st.last_id, st.penult_id, st.has_ts,
            st.seek_delta, st.base_mask, st.initial_mask, st.temperature,
            st.max_tokens, eot, beg, no_timestamps, single_segment)
        if strategy == "beam":
            # candidates, dedup, selection inside each window's group, then
            # every per-lane state follows its parent (the completed/failed
            # flags stay per slot, as in the JAX package); the cache is
            # gathered into a temporary and copied back to its one address
            src, tok, score, seq_hash = _beam_select_grouped(
                logprobs, st.completed, st.failed, st.sum_logprobs,
                st.seq_hash, i, beg, W, G)
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
            tok, p, plog, tid, pt, ptsum = _sample(
                logprobs, probs, temperature, st.gens, beg,
                row_temp=st.temperature[:, 0])
            st.sum_logprobs.copy_(torch.where(live, st.sum_logprobs + plog,
                                              st.sum_logprobs))

        # write buffers for live lanes at column i
        col = (torch.arange(n_max, device=i.device)[None, :] == i) & live[:, None]
        for buf, val in zip(st.buffers(), (tok, tid, p, plog, pt, ptsum)):
            buf.copy_(torch.where(col, val[:, None].to(buf.dtype), buf))
        st.n_tok.copy_(torch.where(live, i + 1, st.n_tok))

        # ---- state rules (src/whisper.cpp:7360-7443), per-row seeks ----
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

        # ---- next-token decode (batched over rows): one write head, each
        # row at its own position ----
        # every step decodes, as the JAX body does: a step after the last
        # lane has finished only writes what nothing reads
        step_pos = torch.clamp(st.pos0 + i, max=hp.n_text_ctx - 1)[:, None]
        logits_next, _ = M.decode_step(
            params, tok[:, None], step_pos, st.head + i, st.cache, st.xk, st.xv,
            hp, dtype=compute_dtype, attn_mask=st.attn_mask, attn_ctx=attn_ctx,
            xkv_group=G if native else 1, parity=parity, tp=tp)
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
                hp, W, G, n_max, n_cells, cache_dtype, kv_itype, xk, xv,
                base_mask.shape[0], V, dev, tp))
        return held["st"]

    def segment_graphs(st: LoopState, params, temperature: float):
        """{attn_ctx: graph} for the call's sampling branch, capturing the
        ones not captured yet (all segments at once, before the windows are
        loaded: the warm-up step runs on the state)."""
        sampling = temperature >= 1e-6 and strategy == "greedy"
        graphs = held["graphs"]
        missing = [a for a in seg_sizes if (a, sampling) not in graphs]
        if missing:
            t0 = time.perf_counter()
            if held["pool"] is None:
                held["pool"] = torch.cuda.graph_pool_handle()
            for a in missing:
                graphs[(a, sampling)] = CG.CountedGraph(
                    lambda a=a: step(st, params, a, temperature), held["pool"],
                    generators=st.gens if sampling else ())
            torch.cuda.synchronize(st.i.device)
            decode_window.capture_us += int((time.perf_counter() - t0) * 1e6)
            decode_window.graphs += len(missing)
        return {a: graphs[(a, sampling)] for a in seg_sizes}

    def prompt_pass(params, prompts, prompt_lens, xk, xv):
        """The prompt decode, one row per window (the lanes of a window
        share it): (its cache, the last prompt row's logits (W, V), their
        softmax, the rows' additive pad mask (W, 1, 1, C) or None)."""
        dev = prompts.device
        if not native:
            cache1 = M.new_cache(hp, 1, cache_dtype, itype=kv_itype, device=dev, tp=tp)
            pos = torch.clamp(torch.arange(prompt_bucket, device=dev), 0,
                              hp.n_text_ctx - 1)[None, :]
            logits_all, cache1 = M.decode_step(
                params, prompts[None, :], pos, 0, cache1, xk, xv, hp,
                dtype=compute_dtype, attn_ctx=prompt_ctx, parity=parity, tp=tp)
            last = logits_all[:, prompt_lens[0] - 1]                    # (1, V)
            return cache1, last, torch.softmax(last[0].float(), dim=-1), None
        # left-pad: cell c of row w holds token c - shift_w; cells below
        # shift_w are pad, never overwritten (steps write bucket + i), so
        # one additive mask hides them for the whole window
        cells, mask_prompt, pad = prompt_pad_masks(prompt_bucket, n_cells,
                                                   prompt_lens, dev)
        prompt_lp = prompts.gather(1, torch.clamp(cells, 0, prompt_bucket - 1))
        pos = torch.clamp(cells, 0, hp.n_text_ctx - 1)
        cache_w = M.new_cache(hp, W, cache_dtype, itype=kv_itype, device=dev,
                              n_cells=n_cells, tp=tp)
        logits_all, cache_w = M.decode_step(
            params, prompt_lp, pos, 0, cache_w, xk, xv, hp, dtype=compute_dtype,
            attn_mask=mask_prompt, attn_ctx=prompt_ctx, parity=parity, tp=tp)
        last = logits_all[:, prompt_bucket - 1]                         # (W, V)
        return cache_w, last, torch.softmax(last.float(), dim=-1), pad

    def run(params, prompt, prompt_len, xk, xv, base_mask, initial_mask,
            temperature, seek, seek_end, max_tokens: int, rng_seed,
            on_graphs: bool) -> WindowResult:
        if native:
            # stacked (W, L, ...) planes as the decoder's (L, W, ...)
            xk, xv = (_map_planes(lambda a: a.transpose(0, 1), x) for x in (xk, xv))
            lens, temps, seeks, ends, seeds = (list(a) for a in (
                prompt_len, temperature, seek, seek_end, rng_seed))
            head = prompt_bucket
        else:
            lens, temps, seeks, ends, seeds = ([a] for a in (
                prompt_len, temperature, seek, seek_end, rng_seed))
            head = prompt_len
        with CG.DEVICE_LOCK, numerics():
            cache_w, last, prompt_probs, pad = prompt_pass(params, prompt, lens,
                                                           xk, xv)
            st = state_for(params, xk, xv, base_mask, last.shape[-1], prompt.device)
            branch = max(temps)
            graphs = segment_graphs(st, params, branch) if on_graphs else None
            st.load(cache_w, last, xk, xv, base_mask, initial_mask, temps, seeks,
                    ends, max_tokens, head, lens, seeds, pad)
            # the host counts the steps, so it picks each step's segment and
            # stops at n_max itself; it reads the done flag every FLAG_EVERY
            # steps (JAX: the while_loop's cond, on the device)
            i = 0
            while i < n_max:
                if on_graphs:
                    graphs[step_ctx(i)].replay()
                else:
                    step(st, params, step_ctx(i), branch)
                i += 1
                if i % FLAG_EVERY == 0 and i < n_max:
                    decode_window.readbacks += 1
                    if bool(st.done):
                        break
            decode_window.windows += W
            if not on_graphs:
                decode_window.eager_windows += W
            decode_window.steps += i
            decode_window.readbacks += 1
            return st.result(prompt_probs)

    def each_window(params, prompt, prompt_len, xk, xv, base_mask, initial_mask,
                    temperature, seek, seek_end, max_tokens: int, rng_seed,
                    on_graphs: bool) -> WindowResult:
        """vmap_windows: the one-window decode of each window of the stacked
        arguments, the results stacked on a leading window axis."""
        res = [run(params, prompt[w], int(prompt_len[w]), _map_planes(lambda a: a[w], xk),
                   _map_planes(lambda a: a[w], xv), base_mask, initial_mask,
                   float(temperature[w]), int(seek[w]), int(seek_end[w]), max_tokens,
                   int(rng_seed[w]), on_graphs)
               for w in range(prompt.shape[0])]
        return WindowResult(*(np.stack(f) for f in zip(*res)))

    call = each_window if vmap_windows and not native else run

    def decode_window(params, prompt, prompt_len, xk, xv, base_mask,
                      initial_mask, temperature, seek, seek_end,
                      max_tokens: int, rng_seed) -> WindowResult:
        on_card = prompt.device.type == "cuda"
        if on_card and not graphs_ok and not decode_window.eager_windows:
            log_info(f"window decoder: eager loop on the card, the tp group's backend "
                     f"({torch.distributed.get_backend(tp)}) cannot be captured\n")
        return call(params, prompt, prompt_len, xk, xv, base_mask, initial_mask,
                    temperature, seek, seek_end, max_tokens, rng_seed,
                    on_graphs=on_card and graphs_ok)

    decode_window.eager = functools.partial(call, on_graphs=False)
    decode_window.windows = decode_window.readbacks = decode_window.steps = 0
    decode_window.graphs = decode_window.capture_us = decode_window.eager_windows = 0
    return decode_window
