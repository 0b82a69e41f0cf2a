"""VAD prefilter integration with the transcription pipeline.

Port of whisper_tpu/models/vad/pipeline.py, a copy but for
`get_vad_context` (the VadContext lives on the Whisper context's device and
is cached by (path, device)) and `filter_speech`, which holds DEVICE_LOCK
across the shared context's detection and the reads that follow it.

Reference behavior: `whisper_vad` (src/whisper.cpp:6667-6827) — run Silero
over the input, cut out the speech segments, concatenate them with 0.1 s
silence gaps, and build a processed-time -> original-time mapping table used
to remap output segment timestamps (`map_processed_to_original_time`,
src/whisper.cpp:7957-7996).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np

from ...decoding.graphs import DEVICE_LOCK
from .silero import (VadContext, VadSegment, cs_to_samples,
                     segments_from_samples, SAMPLE_RATE)

# (processed_time_cs, original_time_cs) pairs, sorted by processed time
MappingTable = List[Tuple[int, int]]

_vad_ctx_cache: dict = {}


def _samples_to_cs(samples: int) -> int:
    return int(samples / SAMPLE_RATE * 100.0 + 0.5)


def get_vad_context(model_path: str, device=None) -> VadContext:
    """Lazily construct + cache one VadContext per (model path, device) (the
    reference keeps it on whisper_state, src/whisper.cpp:6681-6689);
    `device` None is the CUDA card."""
    from ...runtime.context import resolve_device

    key = (model_path, str(resolve_device(device)))
    with DEVICE_LOCK:
        ctx = _vad_ctx_cache.get(key)
        if ctx is None:
            ctx = VadContext.from_file(model_path, device=device)
            _vad_ctx_cache[key] = ctx
    return ctx


def filter_speech(ctx, params, samples: np.ndarray
                  ) -> Optional[Tuple[np.ndarray, MappingTable,
                                      List[Tuple[int, int]]]]:
    """whisper_vad (src/whisper.cpp:6667-6827).

    Returns (filtered_samples, mapping_table, used_segments) where
    used_segments is the [(orig_start_cs, orig_end_cs)] of the speech
    segments actually kept — the reference records these on
    state->vad_segments (src/whisper.cpp:6759-6776) for
    whisper_full_n_vad_segments / _get_vad_segment_t0/t1.
    (samples, empty-table, []) when no speech segments were found.
    Returns None on VAD init failure.
    """
    if not params.vad_model_path:
        return None
    vctx = get_vad_context(params.vad_model_path, getattr(ctx, "device", None))
    vp = params.vad_params
    # the cached context's h/c and probs are shared by the server's threads
    with DEVICE_LOCK:
        segs = segments_from_samples(vctx, vp, samples)
    if not segs:
        return samples, [], []

    n_samples = len(samples)
    overlap_samples = int(vp.samples_overlap * SAMPLE_RATE)
    silence_samples = int(0.1 * SAMPLE_RATE)

    pieces: List[np.ndarray] = []
    mapping: MappingTable = []
    used: List[Tuple[int, int]] = []
    offset = 0
    for i, seg in enumerate(segs):
        start = min(cs_to_samples(seg.start), n_samples - 1)
        end = min(cs_to_samples(seg.end), n_samples - 1)
        original_len = end - start
        if i < len(segs) - 1:
            end = min(end + overlap_samples, n_samples - 1)
        seg_len = end - start
        if seg_len <= 0:
            continue
        used.append((int(seg.start), int(seg.end)))
        vad_start = _samples_to_cs(offset)
        vad_end = _samples_to_cs(offset + original_len)
        mapping.append((vad_start, seg.start))
        mapping.append((vad_end, seg.end))
        pieces.append(samples[start:end])
        offset += seg_len
        if i < len(segs) - 1:
            mapping.append((_samples_to_cs(offset), seg.end))
            mapping.append((_samples_to_cs(offset + silence_samples),
                            segs[i + 1].start))
            pieces.append(np.zeros(silence_samples, np.float32))
            offset += silence_samples

    mapping.sort(key=lambda m: m[0])
    # dedup processed times for monotonic binary search (:6806-6816)
    dedup: MappingTable = []
    for m in mapping:
        if not dedup or m[0] != dedup[-1][0]:
            dedup.append(m)

    filtered = (np.concatenate(pieces).astype(np.float32)
                if pieces else np.zeros(0, np.float32))
    return filtered, dedup, used


def map_processed_to_original_time(t: int, table: MappingTable) -> int:
    """Linear interpolation through the mapping table
    (src/whisper.cpp:7957-7996)."""
    if not table:
        return t
    if t <= table[0][0]:
        return table[0][1]
    if t >= table[-1][0]:
        return table[-1][1]
    idx = bisect.bisect_left([m[0] for m in table], t)
    upper = table[idx]
    if upper[0] == t:
        return upper[1]
    lower = table[idx - 1]
    p_diff = upper[0] - lower[0]
    o_diff = upper[1] - lower[1]
    if p_diff == 0:
        return lower[1]
    return lower[1] + (t - lower[0]) * o_diff // p_diff


def remap_segment_times(segments, table: MappingTable) -> None:
    """Remap t0/t1 of emitted segments back to original audio time
    (whisper_full_get_segment_t0/t1_from_state, src/whisper.cpp:7999-8035),
    enforcing the 10 ms minimum duration."""
    if not table:
        return
    for seg in segments:
        t0 = map_processed_to_original_time(seg.t0, table)
        t1 = map_processed_to_original_time(seg.t1, table)
        if t1 - t0 < 10:
            t1 = t0 + 10
        seg.t0, seg.t1 = t0, t1
        for tok in seg.tokens:
            if hasattr(tok, "t0") and tok.t0 >= 0:
                tok.t0 = map_processed_to_original_time(tok.t0, table)
            if hasattr(tok, "t1") and tok.t1 >= 0:
                tok.t1 = max(map_processed_to_original_time(tok.t1, table),
                             tok.t0 + 1)
