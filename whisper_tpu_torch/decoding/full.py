"""`transcribe` — the full decoding pipeline orchestrator.

Port of whisper_tpu/decoding/full.py (itself a port of
`whisper_full_with_state`, src/whisper.cpp:6829-7786): language
auto-detect, the temperature fallback ladder, greedy and beam-search
decoder fan-out, the per-30s-window seek loop driven by timestamp tokens,
prompt-history carry, failure rules (repetition, entropy, logprob,
no-speech) and segment emission with timestamp-token splitting.

Every decoder rule stays on the host; the tensor work runs in
:class:`WhisperContext`.  Beam state lives in a dense [beam] axis;
reshuffling is a device-side gather (KVCache.reorder).  Before the window
loop `transcribe` runs the Silero VAD prefilter (models/vad/pipeline.py)
when asked, and after each window the DTW token timestamps
(decoding/dtw.py) when the context enabled them.  Grammar-constrained
decoding (decoding/grammar.py) and the ggml-CPU parity mode
(precision="ggml_cpu_f16") take the host token loop, as in the JAX package.
Each pass of the seek loop is a span, `seek.window` (runtime/trace.py),
whose time outside its encode and decode is the loop's host work.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.whisper.hparams import CHUNK_SIZE
from ..runtime import trace
from ..runtime.context import WhisperContext
from .graphs import DEVICE_LOCK
from . import grammar as G
from . import logits as LF
from .languages import lang_id as lang_to_id, lang_str, LANGUAGES
from .params import (HISTORY_CONDITIONING_TEMP_CUTOFF, SamplingStrategy,
                     TranscribeParams)
from .sampling import (Sequence, TokenData, sample_token, sample_token_topk,
                       sequence_score, sequences_equal)

MAX_DECODERS = 8  # WHISPER_MAX_DECODERS
DELTA_MIN = 10    # don't process <100 ms (src/whisper.cpp:6881)


@dataclass
class Segment:
    """whisper_segment (src/whisper.cpp:460-470); t0/t1 in 10 ms ticks."""

    t0: int
    t1: int
    text: str
    no_speech_prob: float = 0.0
    tokens: List[TokenData] = field(default_factory=list)
    speaker_turn_next: bool = False


@dataclass
class _Decoder:
    """whisper_decoder (src/whisper.cpp:797-820)."""

    sequence: Sequence = field(default_factory=Sequence)
    seek_delta: int = 100 * CHUNK_SIZE
    failed: bool = False
    completed: bool = False
    has_ts: bool = False
    grammar: Optional[object] = None
    i_batch: int = 0
    rng: Optional[object] = None  # stdrng.StdRng (reference mt19937 emu)
    # filtered distributions of the last step
    logits: Optional[np.ndarray] = None
    logprobs: Optional[np.ndarray] = None
    probs: Optional[np.ndarray] = None


@dataclass
class _BeamCandidate:
    decoder_idx: int
    seek_delta: int
    has_ts: bool
    sequence: Sequence
    grammar: Optional[object] = None


def lang_auto_detect(ctx: WhisperContext, offset_ms: int = 0) -> Tuple[int, np.ndarray]:
    """whisper_lang_auto_detect_with_state (src/whisper.cpp:4045-4118):
    encode window at offset, decode [SOT], softmax over language tokens."""
    seek = offset_ms // 10
    ctx.encode_window(seek)
    cache = ctx.new_cache(1)
    logits, _ = ctx.decode(np.array([[ctx.vocab.token_sot]], np.int32), 0, cache)
    row = logits[0]
    lang_ids = [ctx.vocab.lang_token(i) for i in range(len(LANGUAGES))]
    lang_logits = row[lang_ids].astype(np.float64)
    ex = np.exp(lang_logits - lang_logits.max())
    probs = ex / ex.sum()
    return int(probs.argmax()), probs.astype(np.float32)


def _tile_cache(cache, n_beam: int):
    """Repeat lane 0 of a 1-lane cache over `n_beam` lanes — every plane of
    it, the q8 cache's scales included."""
    if cache.kv.shape[1] == n_beam:
        return cache
    with DEVICE_LOCK:
        return type(cache)(*(a[:, :1].repeat(1, n_beam, *([1] * (a.ndim - 2)))
                             for a in cache))


def transcribe(ctx: WhisperContext, params: TranscribeParams,
               samples: Optional[np.ndarray]) -> List[Segment]:
    """whisper_full (src/whisper.cpp:7788-7810): optional VAD prefilter, then
    the windowed decode loop.  Returns the segment list."""
    if params.vad:
        from ..models.vad.pipeline import filter_speech

        filtered = filter_speech(ctx, params, samples)
        if filtered is None:
            return []
        samples, ctx.vad_mapping, ctx.vad_segments_used = filtered
    else:
        ctx.vad_mapping = None
        ctx.vad_segments_used = []
    segments = full_with_state(ctx, params, samples)
    if ctx.vad_mapping is not None:
        from ..models.vad.pipeline import remap_segment_times

        remap_segment_times(segments, ctx.vad_mapping)
    return segments


def full_with_state(ctx: WhisperContext, params: TranscribeParams,
                    samples: Optional[np.ndarray]) -> List[Segment]:
    vocab = ctx.vocab
    hp = ctx.hp
    result_all: List[Segment] = []

    if samples is not None and len(samples) > 0:
        ctx.pcm_to_mel(samples)
    if ctx.mel is None:
        # zero-length input on a fresh context: nothing to transcribe (the
        # reference reads out of bounds there, whisper.cpp:7840-7852,
        # undefined behavior this engine deliberately does not reproduce)
        return []

    # language auto-detect
    language = params.language
    if (not ctx.is_empty and (language is None or language == "" or
                              language == "auto" or params.detect_language)):
        lid, probs = lang_auto_detect(ctx)
        ctx.lang_id = lid
        language = lang_str(lid)
        if params.detect_language:
            return []

    if params.token_timestamps:
        ctx.t_beg = 0
        ctx.t_last = 0
        ctx.tid_last = 0
        if samples is not None and len(samples) > 0:
            from .timestamps import get_signal_energy

            ctx.energy = get_signal_energy(samples, 32)

    # seek bounds are in *real-audio* frames (whisper_n_len_from_state returns
    # n_len_org, src/whisper.cpp:3936); the padded mel is longer
    seek_start = params.offset_ms // 10
    seek_end = (ctx.n_len_org if params.duration_ms == 0
                else seek_start + params.duration_ms // 10)

    if seek_end < seek_start + DELTA_MIN:
        return []

    # temperature ladder
    if params.temperature_inc > 0.0:
        temperatures = []
        t = params.temperature
        while t < 1.0 + 1e-6:
            temperatures.append(t)
            t += params.temperature_inc
    else:
        temperatures = [params.temperature]

    # decoder fan-out size
    if params.strategy == SamplingStrategy.GREEDY:
        n_decoders = params.greedy.best_of
    else:
        n_decoders = max(params.greedy.best_of, params.beam_search.beam_size)
    n_decoders = max(1, n_decoders)
    if n_decoders > MAX_DECODERS:
        raise ValueError(f"too many decoders requested ({n_decoders})")

    decoders = [_Decoder() for _ in range(n_decoders)]
    # bit-exact reference RNGs: decoder 0 is seeded 0 at state init
    # (src/whisper.cpp:3480), decoders 1.. are re-seeded j per whisper_full
    # call (:6931); our per-call decoders recreate the fresh-state sequence
    from .stdrng import StdRng

    decoders[0].rng = StdRng(0)
    for j in range(1, n_decoders):
        decoders[j].rng = StdRng(j)

    # prompt history: static (initial prompt) + dynamic (rolling)
    prompt_past0: List[int] = getattr(ctx, "prompt_past0", [])
    prompt_past1: List[int] = getattr(ctx, "prompt_past1", [])
    if params.no_context:
        prompt_past0 = []
        prompt_past1 = []

    max_prompt_ctx = min(params.n_max_text_ctx, hp.n_text_ctx // 2)

    # initial prompt
    prompt_tokens: List[int] = list(params.prompt_tokens or [])
    if not prompt_tokens and params.initial_prompt:
        prompt_tokens = vocab.tokenize(params.initial_prompt)
    if prompt_tokens:
        if params.carry_initial_prompt:
            if not prompt_past0:
                max_tokens = max(1, max_prompt_ctx - 1)
                prompt_past0 = prompt_tokens[-max_tokens:]
        else:
            prompt_past1 = prompt_past1 + prompt_tokens

    if params.audio_ctx > hp.n_audio_ctx:
        raise ValueError("audio_ctx larger than the model maximum")

    # task prompt
    prompt_init = [vocab.token_sot]
    if vocab.is_multilingual:
        lid = lang_to_id(language or "en")
        ctx.lang_id = lid
        prompt_init.append(vocab.lang_token(lid))
        prompt_init.append(vocab.token_translate if params.translate
                           else vocab.token_transcribe)

    # first-release distilled models require the no_timestamps token; the
    # reference keys this on n_text_layer alone (src/whisper.cpp:7005-7014),
    # so ANY 2-text-layer model — including tiny test models — is forced to
    # no_timestamps mode (caught by tests/test_text_parity.py)
    is_distil = hp.n_text_layer == 2 and hp.n_vocab != 51866
    no_timestamps = params.no_timestamps
    if is_distil and not no_timestamps:
        no_timestamps = True
    if no_timestamps:
        prompt_init.append(vocab.token_not)
    params_no_ts = no_timestamps

    # device-loop eligibility: the whole token loop runs with its state on
    # the device unless a host-side feature (grammar, logits callback) is
    # requested.
    # Beam search runs there at t=0 with DETERMINISTIC top-k candidates, as
    # in the JAX package (the reference DRAWS beam_size candidates from the
    # filtered distribution, whisper.cpp:7262, which on a peaked
    # distribution gives copies of the argmax); the mt19937 draws it skips
    # are accounted for below.  At t>0 the reference degrades BEAM_SEARCH
    # to best_of sampling decoders (src/whisper.cpp:7086-7091).
    device_loop_ok = (
        not ctx.is_empty
        and params.grammar_rules is None
        and params.logits_filter_callback is None
        # the parity mode runs the host loop, as in the JAX package: its
        # per-step numpy filters share f64 host arithmetic with the
        # reference's C doubles (the window decoder takes parity=True too)
        and not ctx.parity)

    # abort hook: the reference checks `abort_callback` before every graph
    # compute (src/whisper.cpp:2461,2983) and bails out of whisper_full; here
    # it is polled at the same boundaries (window start, each token-loop
    # decode, between temperature-ladder attempts) and ends the transcription
    # early, returning the segments emitted so far.
    def _aborted() -> bool:
        return bool(params.abort_callback and params.abort_callback(ctx))

    seek = seek_start
    t_start = time.perf_counter()

    while True:
        if params.progress_callback:
            progress = (100 * (seek - seek_start)) // max(1, seek_end - seek_start)
            params.progress_callback(ctx, progress)

        if seek + DELTA_MIN >= seek_end or _aborted():
            break

        if params.encoder_begin_callback:
            if not params.encoder_begin_callback(ctx):
                break

        win = trace.begin("seek.window")
        # encode current window
        if not ctx.is_empty:
            ctx.encode_window(seek, params.audio_ctx)
        else:
            # model-hparams ctx, NOT the -ac truncation (whisper.cpp:6338)
            ctx.filter_tables = LF.LogitFilterTables(vocab, hp.n_audio_ctx)

        # drop history near the very end (hallucination guard)
        if seek > seek_start and seek + 500 >= seek_end:
            prompt_past0 = []
            prompt_past1 = []

        best_decoder_id = 0

        for it, t_cur in enumerate(temperatures):
            if _aborted():
                win.end()
                ctx.prompt_past0 = prompt_past0
                ctx.prompt_past1 = prompt_past1
                return result_all
            if params.strategy == SamplingStrategy.GREEDY:
                n_decoders_cur = params.greedy.best_of if t_cur > 0.0 else 1
            else:
                n_decoders_cur = (params.greedy.best_of if t_cur > 0.0
                                  else params.beam_search.beam_size)
            n_decoders_cur = max(1, n_decoders_cur)

            for j in range(n_decoders_cur):
                d = decoders[j]
                d.sequence = Sequence()
                d.seek_delta = 100 * CHUNK_SIZE
                d.failed = False
                d.completed = False
                d.has_ts = False
                d.grammar = (G.grammar_init(params.grammar_rules,
                                            params.i_start_rule)
                             if params.grammar_rules is not None else None)

            # build prompt for this iteration
            prompt: List[int] = []
            if params.n_max_text_ctx > 0 and t_cur < HISTORY_CONDITIONING_TEMP_CUTOFF:
                can_take0 = params.carry_initial_prompt and bool(prompt_past0)
                can_take1 = bool(prompt_past1)
                if max_prompt_ctx > 0 and (can_take0 or can_take1):
                    prompt.append(vocab.token_prev)
                    n_take0 = 0
                    if can_take0:
                        n_take0 = len(prompt_past0)
                        prompt.extend(prompt_past0[-n_take0:])
                    n_take1 = min(max_prompt_ctx - n_take0 - 1, len(prompt_past1))
                    if n_take1 > 0:
                        prompt.extend(prompt_past1[-n_take1:])
            prompt.extend(prompt_init)

            no_speech_prob = 0.0

            # t>0 attempts draw stochastically; faithful_sampling routes
            # them through the host loop whose StdRng replays the reference
            # binary's exact mt19937 candidate sequence (stdrng.py).
            # beam_sampling="reference" also routes t=0 BEAM attempts there:
            # the host loop's sample_token_topk draws beam_size candidates
            # per decoder per step as the binary does (whisper.cpp:7262)
            faithful_beam = (params.strategy == SamplingStrategy.BEAM_SEARCH
                             and params.beam_sampling == "reference")
            use_device_loop = device_loop_ok and (
                t_cur == 0.0 or not params.faithful_sampling) and not (
                faithful_beam and t_cur == 0.0)
            dl_strategy = ("beam" if (params.strategy ==
                                      SamplingStrategy.BEAM_SEARCH and
                                      t_cur == 0.0) else "greedy")

            if use_device_loop:
                res = ctx.decode_window_device(
                    prompt, n_decoders_cur, t_cur, seek, seek_end, params,
                    params_no_ts, rng_seed=seek * 31 + it,
                    strategy=dl_strategy)
                ctx.no_speech_prob = float(res.prompt_probs[vocab.token_nosp])
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    nt = int(res.n_tok[j])
                    d.sequence.tokens = [
                        TokenData(id=int(res.tok_id[j, c]),
                                  tid=int(res.tok_tid[j, c]),
                                  p=float(res.tok_p[j, c]),
                                  plog=float(res.tok_plog[j, c]),
                                  pt=float(res.tok_pt[j, c]),
                                  ptsum=float(res.tok_ptsum[j, c]))
                        for c in range(nt)]
                    d.sequence.result_len = int(res.result_len[j])
                    d.sequence.sum_logprobs_all = float(res.sum_logprobs[j])
                    d.seek_delta = int(res.seek_delta[j])
                    d.has_ts = bool(res.has_ts[j])
                    d.failed = bool(res.failed[j])
                    d.completed = bool(res.completed[j])
                    if (dl_strategy == "beam" and params.faithful_sampling
                            and d.rng is not None):
                        # the reference's t=0 BEAM attempt draws beam_size
                        # candidates per step from slot j's mt19937
                        # (whisper.cpp:7262, :6600-6604); the device attempt
                        # drew none, so advance the emulated stream to keep
                        # a later host-replayed t>0 fallback at the binary's
                        # exact position (one canonical per draw)
                        d.rng.skip_draws(
                            params.beam_search.beam_size * int(res.n_tok[j]))
            elif not ctx.is_empty:
                # fresh KV; decode the prompt once (beam 0), tile across beams
                cache1 = ctx.new_cache(1)
                logits_row, cache1 = ctx.decode(
                    np.asarray([prompt], np.int32), 0, cache1)
                cache = _tile_cache(cache1, n_decoders_cur)

                # no-speech prob from raw last-prompt-row logits
                raw = logits_row[0]
                lp = LF.compute_logprobs(raw)
                pr = LF.compute_probs(raw, lp)
                no_speech_prob = float(pr[vocab.token_nosp])
                ctx.no_speech_prob = no_speech_prob

                d0 = decoders[0]
                d0.logits, d0.logprobs, d0.probs = LF.process_logits(
                    raw, ctx.filter_tables, params, t_cur,
                    d0.sequence.tokens, d0.has_ts, d0.seek_delta, d0.grammar)
                for j in range(1, n_decoders_cur):
                    d = decoders[j]
                    d.logits = d0.logits.copy()
                    d.logprobs = d0.logprobs.copy()
                    d.probs = d0.probs.copy()
            else:
                cache = None
                n_logits = max(vocab.id_to_token) + 1
                raw = np.zeros(n_logits, np.float32)
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    d.logits, d.logprobs, d.probs = LF.process_logits(
                        raw, ctx.filter_tables, params, t_cur,
                        d.sequence.tokens, d.has_ts, d.seek_delta, d.grammar)

            n_max = 0 if use_device_loop else hp.n_text_ctx // 2 - 4
            for i in range(n_max):
                t0s = time.perf_counter()
                bc_per_dec: List[List[_BeamCandidate]] = [[] for _ in range(n_decoders_cur)]

                # sampling
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    if d.completed or d.failed:
                        continue
                    if params.strategy == SamplingStrategy.GREEDY:
                        td = sample_token(vocab, d.probs, d.logprobs,
                                          best=t_cur < 1e-6, rng=d.rng)
                        d.sequence.tokens.append(td)
                        d.sequence.sum_logprobs_all += td.plog
                    else:
                        for td in sample_token_topk(
                                vocab, d.probs, d.logprobs,
                                params.beam_search.beam_size, d.rng):
                            bc = _BeamCandidate(
                                j, d.seek_delta, d.has_ts, d.sequence.copy(),
                                G.grammar_copy(d.grammar)
                                if d.grammar is not None else None)
                            bc.sequence.tokens.append(td)
                            bc.sequence.sum_logprobs_all += td.plog
                            bc_per_dec[j].append(bc)

                beam_candidates: List[_BeamCandidate] = []
                for bc in bc_per_dec:
                    beam_candidates.extend(bc)
                    if bc:
                        ctx.timings.n_sample += 1

                # beam-search: pick top candidates, reshuffle KV
                if params.strategy == SamplingStrategy.BEAM_SEARCH:
                    beam_candidates.sort(
                        key=lambda c: (-c.sequence.sum_logprobs_all, c.decoder_idx))
                    cur_c = 0
                    src_rows = list(range(n_decoders_cur))
                    for j in range(n_decoders_cur):
                        d = decoders[j]
                        if d.completed or d.failed:
                            continue
                        if cur_c >= len(beam_candidates):
                            cur_c = 0
                        cur = beam_candidates[cur_c]
                        cur_c += 1
                        while (len(beam_candidates) > cur_c and
                               sequences_equal(beam_candidates[cur_c].sequence,
                                               cur.sequence) and i > 0):
                            cur_c += 1
                        d.seek_delta = cur.seek_delta
                        d.has_ts = cur.has_ts
                        # value copy (src/whisper.cpp:7336): a candidate can
                        # seed several decoders; each must own its sequence
                        # and its grammar stacks
                        d.sequence = cur.sequence.copy()
                        d.grammar = (G.grammar_copy(cur.grammar)
                                     if cur.grammar is not None else None)
                        src_rows[j] = cur.decoder_idx
                    if cache is not None and src_rows != list(range(n_decoders_cur)):
                        with DEVICE_LOCK:
                            cache = cache.reorder(torch.tensor(src_rows,
                                                               device=ctx.device))

                # update decoder state
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    if d.completed or d.failed:
                        continue
                    token = d.sequence.tokens[-1]

                    if token.id > vocab.token_beg:
                        seek_delta_new = 2 * (token.id - vocab.token_beg)
                        if (d.has_ts and d.seek_delta > seek_delta_new and
                                d.sequence.result_len < i):
                            d.failed = True
                            continue
                        d.seek_delta = seek_delta_new
                        d.sequence.result_len = i + 1
                        d.has_ts = True

                    if d.grammar is not None:
                        G.accept_token(vocab, d.grammar, token.id)

                    if (token.id == vocab.token_eot or
                            (params.max_tokens > 0 and i >= params.max_tokens) or
                            (d.has_ts and seek + d.seek_delta + DELTA_MIN >= seek_end)):
                        if d.sequence.result_len == 0 and not params_no_ts:
                            if seek + d.seek_delta + DELTA_MIN >= seek_end:
                                d.sequence.result_len = i + 1
                            else:
                                d.failed = True
                                continue
                        if params.single_segment or params_no_ts:
                            d.sequence.result_len = i + 1
                            d.seek_delta = 100 * CHUNK_SIZE
                        d.completed = True
                        continue

                    # test mode (header-only model): complete immediately
                    if ctx.is_empty:
                        d.seek_delta = 100 * CHUNK_SIZE
                        d.completed = True
                        continue

                    # repetition-loop failure
                    if i == n_max - 1 and (d.sequence.result_len == 0 or
                                           d.seek_delta < 100 * CHUNK_SIZE // 2):
                        d.failed = True
                        continue

                if all(d.completed or d.failed for d in decoders[:n_decoders_cur]):
                    break

                ctx.timings.t_sample_us += int((time.perf_counter() - t0s) * 1e6)

                # batched decode of all beams (finished rows decode a dummy
                # token; their outputs are ignored — keeps shapes static)
                if _aborted():
                    win.end()
                    ctx.prompt_past0 = prompt_past0
                    ctx.prompt_past1 = prompt_past1
                    return result_all
                n_past = len(prompt) + i
                step_tokens = np.zeros((n_decoders_cur, 1), np.int32)
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    if not (d.failed or d.completed):
                        step_tokens[j, 0] = d.sequence.tokens[-1].id
                logits_rows, cache = ctx.decode(step_tokens, n_past, cache)

                t0s = time.perf_counter()
                for j in range(n_decoders_cur):
                    d = decoders[j]
                    if d.failed or d.completed:
                        continue
                    d.logits, d.logprobs, d.probs = LF.process_logits(
                        logits_rows[j], ctx.filter_tables, params, t_cur,
                        d.sequence.tokens, d.has_ts, d.seek_delta, d.grammar)
                ctx.timings.t_sample_us += int((time.perf_counter() - t0s) * 1e6)

            # rank sequences
            best_score = -math.inf
            for j in range(n_decoders_cur):
                d = decoders[j]
                if d.failed:
                    continue
                d.sequence.tokens = d.sequence.tokens[: d.sequence.result_len]
                sequence_score(d.sequence, params.length_penalty)
                if (d.sequence.result_len > 32 and
                        d.sequence.entropy < params.entropy_thold):
                    d.failed = True
                    ctx.timings.n_fail_h += 1
                    continue
                if best_score < d.sequence.score:
                    best_score = d.sequence.score
                    best_decoder_id = j

            # fallback decision
            success = True
            if it != len(temperatures) - 1:
                d = decoders[best_decoder_id]
                if (d.failed or (d.sequence.avg_logprobs < params.logprob_thold and
                                 ctx.no_speech_prob < params.no_speech_thold)):
                    success = False
                    ctx.timings.n_fail_p += 1
            if success:
                break

        # emit results
        best = decoders[best_decoder_id]
        seek_delta = best.seek_delta
        result_len = best.sequence.result_len
        tokens_cur = best.sequence.tokens

        is_no_speech = (ctx.no_speech_prob > params.no_speech_thold and
                        best.sequence.avg_logprobs < params.logprob_thold)

        # update rolling context
        new_past1: List[int] = []
        if (not params.carry_initial_prompt and prompt and
                prompt[0] == vocab.token_prev):
            new_past1 = prompt[1: len(prompt) - len(prompt_init)]
        prompt_past1 = new_past1
        if not is_no_speech:
            prompt_past1 = prompt_past1 + [t.id for t in tokens_cur[:result_len]]

        n_segments_before_window = len(result_all)

        if tokens_cur and not ctx.is_empty and not is_no_speech:
            i0 = 0
            t0 = seek + 2 * (tokens_cur[0].tid - vocab.token_beg)
            text = ""
            speaker_turn_next = False
            n_seg_before = len(result_all)

            i = 0
            while i < len(tokens_cur):
                tok = tokens_cur[i]
                if params.print_special or tok.id < vocab.token_eot:
                    text += vocab.token_str(tok.id)
                if params.tdrz_enable and tok.id == vocab.token_solm:
                    speaker_turn_next = True

                if tok.id > vocab.token_beg and not params.single_segment:
                    t1 = seek + 2 * (tok.tid - vocab.token_beg)
                    if text:
                        seg = Segment(t0, t1, text, ctx.no_speech_prob,
                                      tokens_cur[i0: i + 1], speaker_turn_next)
                        result_all.append(seg)
                        _post_segment(ctx, params, result_all, seek)
                    text = ""
                    t0 = t1
                    while (i + 1 < len(tokens_cur) and
                           tokens_cur[i + 1].id > vocab.token_beg):
                        i += 1
                        if params.print_special:
                            text += vocab.token_str(tokens_cur[i].id)
                        t0 = seek + 2 * (tokens_cur[i].tid - vocab.token_beg)
                    i0 = i + 1
                    speaker_turn_next = False
                i += 1

            if text:
                t1 = seek + seek_delta
                seg = Segment(t0, t1, text, ctx.no_speech_prob,
                              tokens_cur[i0:], speaker_turn_next)
                result_all.append(seg)
                _post_segment(ctx, params, result_all, seek)

        # [EXPERIMENTAL] DTW token-level timestamps for this window's
        # segments (src/whisper.cpp:7749-7762)
        n_seg_new = len(result_all) - n_segments_before_window
        if ctx.dtw_token_timestamps and n_seg_new:
            from .dtw import compute_token_level_timestamps_dtw

            n_frames = min(CHUNK_SIZE * 100, seek_delta, seek_end - seek)
            compute_token_level_timestamps_dtw(
                ctx, params, result_all, len(result_all) - n_seg_new,
                n_seg_new, seek, n_frames, medfilt_width=7)

        # single-timestamp ending: skip the whole chunk (PR 2629)
        max_tokens_ts_ending = (params.max_tokens > 0 and not params.single_segment
                                and len(tokens_cur) > params.max_tokens)
        single_ts_ending = (len(tokens_cur) > 1 and not max_tokens_ts_ending and
                            tokens_cur[-2].id < vocab.token_beg and
                            tokens_cur[-1].id > vocab.token_beg)
        if single_ts_ending:
            seek_delta = min(seek_end - seek, CHUNK_SIZE * 100)

        seek += seek_delta
        win.end()

    # persist rolling context for streaming use (stream example carries it)
    ctx.prompt_past0 = prompt_past0
    ctx.prompt_past1 = prompt_past1
    return result_all


def _post_segment(ctx, params, result_all, seek) -> None:
    """Token-level timestamps + segment wrapping + callback for the segment
    just appended (src/whisper.cpp:7686-7700)."""
    if params.print_realtime:
        # in-pipeline segment printing (src/whisper.cpp:7667-7674)
        seg = result_all[-1]
        if params.print_timestamps:
            print(f"[{to_timestamp(seg.t0)} --> {to_timestamp(seg.t1)}]  "
                  f"{seg.text}")
        else:
            print(seg.text, end="", flush=True)
    n_new = 1
    if params.token_timestamps:
        from .timestamps import compute_token_level_timestamps, wrap_segment

        compute_token_level_timestamps(ctx, result_all, len(result_all) - 1,
                                       params.thold_pt, params.thold_ptsum)
        if params.max_len > 0:
            n_new = wrap_segment(ctx, result_all, params.max_len,
                                 params.split_on_word)
    if params.new_segment_callback:
        params.new_segment_callback(ctx, result_all, n_new)


def _cdiv(a: int, b: int) -> int:
    """C++ integer division (truncates toward zero; Python // floors).
    Matters for the negative-t0 segments the reference's greedy tid-zero
    quirk can produce (src/whisper.cpp:7642)."""
    return -(-a // b) if (a < 0) != (b < 0) else a // b


def to_timestamp(t: int, comma: bool = False) -> str:
    """10ms ticks -> 'HH:MM:SS.mmm' (common-whisper.cpp:182 to_timestamp;
    int64 C division semantics for negative ticks)."""
    msec = t * 10
    hr = _cdiv(msec, 1000 * 60 * 60)
    msec -= hr * 1000 * 60 * 60
    mi = _cdiv(msec, 1000 * 60)
    msec -= mi * 1000 * 60
    s = _cdiv(msec, 1000)
    msec -= s * 1000
    sep = "," if comma else "."
    return f"{hr:02d}:{mi:02d}:{s:02d}{sep}{msec:03d}"
