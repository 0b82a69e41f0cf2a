"""Data-parallel transcription over audio chunks.

Port of whisper_tpu/decoding/parallel.py, itself a port of
`whisper_full_parallel` (src/whisper.cpp:7811-7939): the audio is split
into `n_processors` equal chunks, each transcribed with its own decode
state against the shared model, and segments are merged with timestamp
offset fix-up and a non-overlap clamp.  By default the chunks run in
worker threads whose window decodes batch natively on the card
(runtime/batching.py); `batched=False` runs them one after another.  With
`params.vad` the whole audio is VAD-filtered first, the filtered samples
are chunked, and the merged segments' times are mapped back to the
original audio (`_remap_vad`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .full import Segment, full_with_state
from .params import TranscribeParams

SAMPLE_RATE = 16000


def transcribe_parallel(ctx, params: TranscribeParams, samples: np.ndarray,
                        n_processors: int,
                        batched: Optional[bool] = None,
                        batcher=None) -> List[Segment]:
    """`batcher`: optional shared WindowBatcher (server-wide lockstep
    coalescing across concurrent requests — runtime/batching.py)."""
    if n_processors <= 1:
        from .full import transcribe

        if batcher is not None:
            from ..runtime.batching import transcribe_joining

            return transcribe_joining(ctx, params, samples, batcher)[0]
        return transcribe(ctx, params, samples)

    vad_mapping = None
    if params.vad:
        from ..models.vad.pipeline import filter_speech

        filtered = filter_speech(ctx, params, samples)
        if filtered is None:
            return []
        samples, vad_mapping, ctx.vad_segments_used = filtered
        # The reference VADs the WHOLE audio up front, chunks the filtered
        # samples, merges worker segments with filtered-time chunk offsets,
        # and the public accessors then remap the merged t0/t1 through the
        # PARENT state's mapping table (whisper_full_parallel:7824 ->
        # whisper_vad fills ctx->state->vad_mapping_table;
        # whisper_full_get_segment_t0/t1:7999-8035) — so the remap applies
        # after the merge below.  (The reference workers also re-run VAD on
        # their already-filtered chunks — params_cur.vad is never cleared —
        # which is a no-op on speech-only samples; this engine skips the
        # second pass.)

    # lockstep continuous batching: the chunks' windows decode together
    # (runtime/batching.py) whenever the device loop covers the requested
    # decoding features
    eligible = (not ctx.is_empty
                and params.grammar_rules is None
                and params.logits_filter_callback is None
                and not params.detect_language
                and (params.language or "en") != "auto")
    if batched is None:
        batched = eligible
    if batched and eligible:
        from ..runtime.batching import transcribe_batched

        return transcribe_batched(ctx, params, samples, n_processors,
                                  batcher=batcher, vad_mapping=vad_mapping)

    n_samples = len(samples)
    offset_samples = (SAMPLE_RATE * params.offset_ms) // 1000
    n_per = (n_samples - offset_samples) // n_processors

    all_segments: List[Segment] = []
    offset_t = params.offset_ms // 10

    for i in range(n_processors):
        if i == 0:
            chunk = samples[: offset_samples + n_per]
            p = replace_params(params)
        else:
            start = offset_samples + i * n_per
            n_cur = n_samples - start if i == n_processors - 1 else n_per
            chunk = samples[start: start + n_cur]
            p = replace_params(params, clear_offset=True)

        # empty chunk (offset at/past end of audio): nothing to decode —
        # without this guard the shared ctx would re-decode the PREVIOUS
        # chunk's still-loaded mel
        segs = full_with_state(ctx, p, chunk) if len(chunk) else []
        # fresh rolling context between chunks
        ctx.prompt_past0, ctx.prompt_past1 = [], []

        if i == 0:
            all_segments.extend(segs)
        else:
            shift = 100 * (i * n_per) // SAMPLE_RATE + offset_t
            for s in segs:
                s.t0 += shift
                s.t1 += shift
                if all_segments:
                    s.t0 = max(s.t0, all_segments[-1].t1)
                all_segments.append(s)
                if params.new_segment_callback:
                    params.new_segment_callback(ctx, all_segments, 1)
    return _remap_vad(all_segments, vad_mapping)


def _remap_vad(segments, table):
    """Filtered-time -> original-time remap of the MERGED segments
    (whisper_full_get_segment_t0/t1 applied after whisper_full_parallel's
    chunk-offset fix-up, src/whisper.cpp:7890-7894 + :7999-8035).

    The remap must run AFTER the whole merge, like the reference's read-time
    accessors: the mapping table is sorted by processed time but its
    original times can step backward across entries (speech-pad overlap),
    so the non-overlap clamp compares filtered-time values.  Mid-merge
    new_segment_callbacks therefore see filtered-time stamps, as in the
    JAX package."""
    if table:
        from ..models.vad.pipeline import remap_segment_times

        remap_segment_times(segments, table)
    return segments


def replace_params(params: TranscribeParams, clear_offset: bool = False):
    import copy

    p = copy.copy(params)
    p.vad = False  # already applied above
    if clear_offset:
        p.offset_ms = 0
        p.print_progress = False
        p.print_realtime = False  # workers must not interleave stdout
        p.new_segment_callback = None
        p.progress_callback = None
    return p
