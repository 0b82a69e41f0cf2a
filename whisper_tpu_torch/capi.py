"""Handle-based procedural API mirroring whisper.h — the bridge surface for
the C ABI shim (native/whisper_abi.cpp).

The reference's public contract is a procedural C API over opaque contexts
(include/whisper.h:201-767: whisper_init_from_file_with_params,
whisper_full, whisper_full_n_segments, whisper_full_get_segment_*, ...).
whisper_tpu's native surface is the Python API + HTTP server; this module
reproduces the whisper.h call shapes over integer handles so a C host (or
any FFI) can drive the engine with the same call sequence a whisper.cpp
consumer uses.  Params cross the boundary as a JSON object holding
whisper_full_params field names (strategy, language, translate,
beam_search.beam_size, ...), which sidesteps C struct-layout coupling while
keeping field-level parity.

Port of whisper_tpu/capi.py: the same names, signatures, integer handles
and JSON params over the port's WhisperContext, VadContext and
ParakeetContext, behind the shim whisper_tpu_torch/native/whisper_abi.cpp
(whisper_tpu_torch/abi.py builds it).  The device is chosen at init from
whisper_context_params' `use_gpu` and `gpu_device`: true (whisper.h's
default) is the CUDA card `cuda:<gpu_device>`, false the CPU.  With no card
and use_gpu true, init logs why and returns 0 (a NULL context), as
whisper.cpp does on a failed init; it never carries on on the CPU.  The VAD
context's `use_gpu` defaults to false, as whisper.cpp's does.  The
low-level compute entry points hold decoding/graphs.py DEVICE_LOCK, as
every device section of the port does.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict, Optional

import numpy as np

from .decoding.graphs import DEVICE_LOCK
from .runtime.logging import log_error

_contexts: Dict[int, object] = {}
_segments: Dict[int, list] = {}
# state handles (whisper_init_state, whisper.h:214): a state is a cloned
# context sharing the parent's weights, with its own mel/KV/segment results
_states: Dict[int, object] = {}
_state_segments: Dict[int, list] = {}
# per-handle scratch from compute entry points (decode logits, lang probs,
# the 1-beam KV cache whisper_decode threads between calls)
_scratch: Dict[int, dict] = {}
_handle = itertools.count(1)


def _device(cp: dict, what: str) -> Optional[str]:
    """The device that context params' use_gpu (default true) and
    gpu_device choose: "cuda:<gpu_device>" or "cpu"; None, with the reason
    logged, when they ask for a card and there is none."""
    if not cp.get("use_gpu", True):
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        log_error(f"{what}: use_gpu is set and no CUDA card is available "
                  "(set use_gpu = false to run on the CPU)\n")
        return None
    return f"cuda:{int(cp.get('gpu_device', 0))}"


def _init(path: str, cp: dict) -> int:
    """A context handle on the device `cp` chooses (0 on failure)."""
    from .runtime.context import WhisperContext

    device = _device(cp, "whisper_init")
    if device is None:
        return 0
    try:
        ctx = WhisperContext.from_file(path, device=device)
    except Exception:
        return 0
    h = next(_handle)
    _contexts[h] = ctx
    _segments[h] = []
    return h


def _from_buffer(data: bytes, init) -> int:
    """init(path) on `data` written to a temporary file."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".bin")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(bytes(data))
        return init(path)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def init_from_file(path: str) -> int:
    """whisper_init_from_file_with_params (whisper.h:210) at the default
    context params (use_gpu: the CUDA card): returns a handle (0 on
    failure, mirroring the NULL context)."""
    return _init(path, {})


def init_from_buffer(data: bytes) -> int:
    """whisper_init_from_buffer_with_params (whisper.h:216): loads a model
    from an in-memory byte buffer."""
    return _from_buffer(data, init_from_file)


def free(h: int) -> None:
    """whisper_free (whisper.h:253)."""
    _contexts.pop(h, None)
    _segments.pop(h, None)
    _scratch.pop(h, None)


def init_state(h: int) -> int:
    """whisper_init_state (whisper.h:214): a decode state sharing the
    context's weights.  Implemented as WhisperContext.clone_state (shares
    params; fresh mel/KV/timings) + a per-state segment list."""
    ctx = _contexts.get(h)
    if ctx is None:
        return 0
    sh = next(_handle)
    _states[sh] = ctx.clone_state()
    _state_segments[sh] = []
    return sh


def free_state(sh: int) -> None:
    """whisper_free_state (whisper.h:255)."""
    _states.pop(sh, None)
    _state_segments.pop(sh, None)
    _scratch.pop(sh, None)


def _params_from_json(spec: Optional[str]):
    from .decoding.params import (SamplingStrategy, TranscribeParams,
                                  VadParams)

    obj = json.loads(spec) if spec else {}
    strat = obj.get("strategy", 0)
    p = TranscribeParams.default(
        SamplingStrategy.BEAM_SEARCH if strat == 1
        else SamplingStrategy.GREEDY)
    p.print_progress = False
    for key, val in obj.items():
        if key == "strategy":
            continue
        if key == "greedy.best_of":
            p.greedy.best_of = int(val)
        elif key == "beam_search.beam_size":
            p.beam_search.beam_size = int(val)
        elif key == "beam_search.patience":
            p.beam_search.patience = float(val)
        elif key == "grammar_rules" and val:
            # [[ [type, value], ... ], ...] -> List[List[GElement]]
            from .decoding.grammar import GElement, GType

            p.grammar_rules = [
                [GElement(GType(int(t)), int(v)) for t, v in rule]
                for rule in val]
        elif key == "vad_params" and isinstance(val, dict):
            vp = VadParams()
            for k2, v2 in val.items():
                if hasattr(vp, k2):
                    setattr(vp, k2, v2)
            p.vad_params = vp
        elif hasattr(p, key):
            setattr(p, key, val)
    return p


def full(h: int, params_json: Optional[str], samples: np.ndarray) -> int:
    """whisper_full (whisper.h:657): 0 on success.  Goes through
    transcribe() so the optional VAD prefilter runs, like the reference's
    whisper_full_with_state (src/whisper.cpp:6957-6976)."""
    from .decoding.full import transcribe

    ctx = _contexts.get(h)
    if ctx is None:
        return -1
    try:
        p = _params_from_json(params_json)
        segs = transcribe(ctx, p, np.asarray(samples, np.float32))
    except Exception:
        return -6  # whisper_full's failed-decode code
    _segments[h] = segs
    return 0


def full_parallel(h: int, params_json: Optional[str], samples: np.ndarray,
                  n_processors: int) -> int:
    """whisper_full_parallel (whisper.h:666)."""
    from .decoding.parallel import transcribe_parallel

    ctx = _contexts.get(h)
    if ctx is None:
        return -1
    try:
        p = _params_from_json(params_json)
        segs = transcribe_parallel(ctx, p, np.asarray(samples, np.float32),
                                   n_processors)
    except Exception:
        return -6
    _segments[h] = segs
    return 0


def full_n_segments(h: int) -> int:
    return len(_segments.get(h, []))


def full_get_segment_t0(h: int, i: int) -> int:
    return int(_segments[h][i].t0)


def full_get_segment_t1(h: int, i: int) -> int:
    return int(_segments[h][i].t1)


def full_get_segment_text(h: int, i: int) -> str:
    return _segments[h][i].text


def full_get_segment_speaker_turn_next(h: int, i: int) -> bool:
    return bool(getattr(_segments[h][i], "speaker_turn_next", False))


def full_n_tokens(h: int, i: int) -> int:
    return len(_segments[h][i].tokens)


def full_get_token_id(h: int, i: int, j: int) -> int:
    return int(_segments[h][i].tokens[j].id)


def full_get_token_p(h: int, i: int, j: int) -> float:
    return float(_segments[h][i].tokens[j].p)


def lang_max_id() -> int:
    from .decoding.languages import LANGUAGES

    return len(LANGUAGES) - 1


def lang_id(s: str) -> int:
    from .decoding.languages import lang_id as _lid

    return _lid(s)


def lang_str(i: int) -> str:
    from .decoding.languages import lang_str as _lstr

    return _lstr(i) or ""


def print_timings(h: int) -> None:
    ctx = _contexts.get(h)
    if ctx is not None:
        ctx.timings.print()


def reset_timings(h: int) -> None:
    """whisper_reset_timings (whisper.h:763)."""
    from .runtime.context import ContextTimings

    ctx = _contexts.get(h)
    if ctx is not None:
        ctx.timings = ContextTimings()


def system_info() -> str:
    from .runtime.logging import print_system_info

    return print_system_info()


def version() -> str:
    """whisper_version (whisper.h:767)."""
    from . import __version__

    return __version__


# ---------------------------------------------------------------------------
# state-based results (whisper_full_with_state + *_from_state accessors,
# whisper.h:650, 680-745).  A state handle owns its own mel/KV/segments, so
# several transcriptions can run against one weight set.
# ---------------------------------------------------------------------------

def full_with_state(h: int, sh: int, params_json: Optional[str],
                    samples: np.ndarray) -> int:
    """whisper_full_with_state (whisper.h:650).  Goes through transcribe()
    on the state's cloned context so the VAD prefilter runs."""
    from .decoding.full import transcribe

    state = _states.get(sh)
    if _contexts.get(h) is None or state is None:
        return -1
    try:
        p = _params_from_json(params_json)
        segs = transcribe(state, p, np.asarray(samples, np.float32))
    except Exception:
        return -6
    _state_segments[sh] = segs
    return 0


# ---------------------------------------------------------------------------
# struct-params entry point (whisper.h:487-591): whisper_full with the real
# whisper_full_params struct.  The C shim converts the struct's scalar
# fields to the JSON the _params_from_json path already speaks and passes
# the five function-pointer callbacks (whisper.h:455-478) as addresses;
# here they are wrapped into ctypes trampolines onto the Python callbacks
# TranscribeParams already carries, so a pure-C host can stream segments
# mid-run, report progress, veto the encoder, abort, and rewrite logits —
# the exact surface every reference binding is built on
# (bindings/go/whisper.go:20-44).
# ---------------------------------------------------------------------------

_c_token_data = None  # lazy ctypes.Structure mirroring whisper_token_data


def _ctypes_token_data():
    global _c_token_data
    if _c_token_data is None:
        import ctypes

        class CTokenData(ctypes.Structure):
            # include/whisper.h:88-108 field order; ctypes computes the
            # same alignment/stride (56 bytes) the C compiler does
            _fields_ = [("id", ctypes.c_int32), ("tid", ctypes.c_int32),
                        ("p", ctypes.c_float), ("plog", ctypes.c_float),
                        ("pt", ctypes.c_float), ("ptsum", ctypes.c_float),
                        ("t0", ctypes.c_int64), ("t1", ctypes.c_int64),
                        ("t_dtw", ctypes.c_int64), ("vlen", ctypes.c_float)]

        _c_token_data = CTokenData
    return _c_token_data


def _install_c_callbacks(p, h: int, sh: int, cb_json: Optional[str],
                         keepalive: list) -> None:
    """Wire C function pointers (addresses in cb_json) into TranscribeParams'
    Python callbacks.  cb_json keys: new_segment/progress/encoder_begin/
    abort/logits_filter (+ _ud suffixes).  The new_segment wrapper also
    publishes the live segment list into the accessor tables so the C host
    can call whisper_full_get_segment_* from inside the callback, mid-run
    (reference contract: whisper.h:456-458)."""
    import ctypes

    cbs = json.loads(cb_json) if cb_json else {}
    seg_table, seg_key = (_state_segments, sh) if sh else (_segments, h)

    def publish(result_all):
        seg_table[seg_key] = result_all

    ns_addr = cbs.get("new_segment", 0)
    ns_fn = (ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_void_p)(ns_addr)
             if ns_addr else None)
    ns_ud = ctypes.c_void_p(cbs.get("new_segment_ud", 0))

    def new_segment(ctx, result_all, n_new):
        publish(result_all)
        if ns_fn is not None:
            ns_fn(h, sh, n_new, ns_ud)

    p.new_segment_callback = new_segment
    keepalive.extend([ns_fn, ns_ud])

    if cbs.get("progress"):
        pr_fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p)(
            cbs["progress"])
        pr_ud = ctypes.c_void_p(cbs.get("progress_ud", 0))
        p.progress_callback = lambda ctx, progress: pr_fn(
            h, sh, int(progress), pr_ud)
        keepalive.extend([pr_fn, pr_ud])

    if cbs.get("encoder_begin"):
        eb_fn = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p)(
            cbs["encoder_begin"])
        eb_ud = ctypes.c_void_p(cbs.get("encoder_begin_ud", 0))
        p.encoder_begin_callback = lambda ctx: bool(eb_fn(h, sh, eb_ud))
        keepalive.extend([eb_fn, eb_ud])

    if cbs.get("abort"):
        # ggml_abort_callback (ggml.h): bool (*)(void * data); true = abort
        ab_fn = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_void_p)(cbs["abort"])
        ab_ud = ctypes.c_void_p(cbs.get("abort_ud", 0))
        p.abort_callback = lambda ctx: bool(ab_fn(ab_ud))
        keepalive.extend([ab_fn, ab_ud])

    if cbs.get("logits_filter"):
        CTok = _ctypes_token_data()
        lf_fn = ctypes.CFUNCTYPE(
            None, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(CTok),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p)(cbs["logits_filter"])
        lf_ud = ctypes.c_void_p(cbs.get("logits_filter_ud", 0))

        def logits_filter(tokens_cur, logits):
            n = len(tokens_cur)
            arr = (CTok * max(n, 1))()
            for k, td in enumerate(tokens_cur):
                arr[k].id = int(td.id)
                arr[k].tid = int(td.tid)
                arr[k].p = float(td.p)
                arr[k].plog = float(td.plog)
                arr[k].pt = float(td.pt)
                arr[k].ptsum = float(td.ptsum)
                arr[k].t0 = int(td.t0)
                arr[k].t1 = int(td.t1)
                arr[k].t_dtw = int(td.t_dtw)
                arr[k].vlen = float(td.vlen)
            # logits is the filter chain's contiguous f32 working copy —
            # the C callback mutates it in place, exactly like the
            # reference (whisper.h:473-478)
            lf_fn(h, sh, arr,
                  n, logits.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                  lf_ud)

        p.logits_filter_callback = logits_filter
        keepalive.extend([lf_fn, lf_ud])


def full_struct(h: int, sh: int, params_json: Optional[str],
                cb_json: Optional[str], samples: np.ndarray) -> int:
    """whisper_full / whisper_full_with_state with struct params + C
    callbacks.  sh=0 runs on the context (whisper_full), else on the state
    (whisper_full_with_state)."""
    from .decoding.full import transcribe

    if sh:
        target = _states.get(sh)
        if _contexts.get(h) is None or target is None:
            return -1
    else:
        target = _contexts.get(h)
        if target is None:
            return -1
    try:
        p = _params_from_json(params_json)
        keepalive: list = []
        _install_c_callbacks(p, h, sh, cb_json, keepalive)
        segs = transcribe(target, p, np.asarray(samples, np.float32))
    except Exception:
        return -6
    if sh:
        _state_segments[sh] = segs
    else:
        _segments[h] = segs
    return 0


def full_parallel_struct(h: int, params_json: Optional[str],
                         cb_json: Optional[str], samples: np.ndarray,
                         n_processors: int) -> int:
    """whisper_full_parallel with struct params + C callbacks (the merge
    loop fires new_segment per stitched segment, src/whisper.cpp:9330)."""
    from .decoding.parallel import transcribe_parallel

    ctx = _contexts.get(h)
    if ctx is None:
        return -1
    try:
        p = _params_from_json(params_json)
        keepalive: list = []
        _install_c_callbacks(p, h, 0, cb_json, keepalive)
        segs = transcribe_parallel(ctx, p, np.asarray(samples, np.float32),
                                   n_processors)
    except Exception:
        return -6
    _segments[h] = segs
    return 0


def full_n_segments_from_state(sh: int) -> int:
    return len(_state_segments.get(sh, []))


def full_get_segment_t0_from_state(sh: int, i: int) -> int:
    return int(_state_segments[sh][i].t0)


def full_get_segment_t1_from_state(sh: int, i: int) -> int:
    return int(_state_segments[sh][i].t1)


def full_get_segment_text_from_state(sh: int, i: int) -> str:
    return _state_segments[sh][i].text


def full_get_segment_speaker_turn_next_from_state(sh: int, i: int) -> bool:
    return bool(getattr(_state_segments[sh][i], "speaker_turn_next", False))


def full_get_segment_no_speech_prob_from_state(sh: int, i: int) -> float:
    return float(_state_segments[sh][i].no_speech_prob)


def full_n_tokens_from_state(sh: int, i: int) -> int:
    return len(_state_segments[sh][i].tokens)


def full_get_token_id_from_state(sh: int, i: int, j: int) -> int:
    return int(_state_segments[sh][i].tokens[j].id)


def full_get_token_p_from_state(sh: int, i: int, j: int) -> float:
    return float(_state_segments[sh][i].tokens[j].p)


def full_lang_id_from_state(sh: int) -> int:
    state = _states.get(sh)
    return int(getattr(state, "lang_id", 0)) if state is not None else -1


# ---------------------------------------------------------------------------
# segment/token accessors beyond the basics (whisper.h:700-745)
# ---------------------------------------------------------------------------

def full_get_segment_no_speech_prob(h: int, i: int) -> float:
    """whisper_full_get_segment_no_speech_prob (whisper.h:712)."""
    return float(_segments[h][i].no_speech_prob)


def full_get_token_text(h: int, i: int, j: int) -> str:
    """whisper_full_get_token_text (whisper.h:729)."""
    ctx = _contexts[h]
    return ctx.vocab.token_str(_segments[h][i].tokens[j].id)


def full_get_token_t0(h: int, i: int, j: int) -> int:
    return int(_segments[h][i].tokens[j].t0)


def full_get_token_t1(h: int, i: int, j: int) -> int:
    return int(_segments[h][i].tokens[j].t1)


def full_get_token_data_json(h: int, i: int, j: int) -> str:
    """whisper_full_get_token_data (whisper.h:733) — the whisper_token_data
    struct crosses the FFI as JSON (same no-struct-coupling rule as
    params)."""
    import dataclasses

    return json.dumps(dataclasses.asdict(_segments[h][i].tokens[j]))


def full_lang_id(h: int) -> int:
    """whisper_full_lang_id (whisper.h:676)."""
    ctx = _contexts.get(h)
    return int(getattr(ctx, "lang_id", 0)) if ctx is not None else -1


# ---------------------------------------------------------------------------
# model / vocab introspection (whisper.h:270-330, 420-436)
# ---------------------------------------------------------------------------

def _hp(h: int):
    return _obj(h).hp


def n_vocab(h: int) -> int:
    """Accepts a context OR state handle — the C shim's
    whisper_get_logits_from_state sizes its buffer through here."""
    return int(_obj(h).vocab.n_vocab)


def n_len(h: int) -> int:
    """whisper_n_len: current mel length in frames."""
    return int(_obj(h).n_len)


def n_audio_ctx(h: int) -> int:
    return int(_hp(h).n_audio_ctx)


def n_text_ctx(h: int) -> int:
    return int(_hp(h).n_text_ctx)


def is_multilingual(h: int) -> int:
    return 1 if _contexts[h].vocab.is_multilingual else 0


def model_n_vocab(h: int) -> int:
    return int(_hp(h).n_vocab)


def model_n_audio_ctx(h: int) -> int:
    return int(_hp(h).n_audio_ctx)


def model_n_audio_state(h: int) -> int:
    return int(_hp(h).n_audio_state)


def model_n_audio_head(h: int) -> int:
    return int(_hp(h).n_audio_head)


def model_n_audio_layer(h: int) -> int:
    return int(_hp(h).n_audio_layer)


def model_n_text_ctx(h: int) -> int:
    return int(_hp(h).n_text_ctx)


def model_n_text_state(h: int) -> int:
    return int(_hp(h).n_text_state)


def model_n_text_head(h: int) -> int:
    return int(_hp(h).n_text_head)


def model_n_text_layer(h: int) -> int:
    return int(_hp(h).n_text_layer)


def model_n_mels(h: int) -> int:
    return int(_hp(h).n_mels)


def model_ftype(h: int) -> int:
    return int(_contexts[h].model.wtype)


def model_type(h: int) -> int:
    """whisper_model_type (e_model from n_audio_layer,
    src/whisper.cpp:1525-1547)."""
    return {4: 1, 6: 2, 12: 3, 24: 4, 32: 5}.get(
        int(_hp(h).n_audio_layer), 0)


def model_type_readable(h: int) -> str:
    return {4: "tiny", 6: "base", 12: "small", 24: "medium",
            32: "large"}.get(int(_hp(h).n_audio_layer), "unknown")


# ---------------------------------------------------------------------------
# special tokens + tokenizer (whisper.h:350-436)
# ---------------------------------------------------------------------------

def token_eot(h: int) -> int:
    return int(_contexts[h].vocab.token_eot)


def token_sot(h: int) -> int:
    return int(_contexts[h].vocab.token_sot)


def token_solm(h: int) -> int:
    return int(_contexts[h].vocab.token_solm)


def token_prev(h: int) -> int:
    return int(_contexts[h].vocab.token_prev)


def token_nosp(h: int) -> int:
    return int(_contexts[h].vocab.token_nosp)


def token_not(h: int) -> int:
    return int(_contexts[h].vocab.token_not)


def token_beg(h: int) -> int:
    return int(_contexts[h].vocab.token_beg)


def token_lang(h: int, lid: int) -> int:
    return int(_contexts[h].vocab.lang_token(lid))


def token_translate(h: int) -> int:
    return int(_contexts[h].vocab.token_translate)


def token_transcribe(h: int) -> int:
    return int(_contexts[h].vocab.token_transcribe)


def token_to_str(h: int, tid: int) -> str:
    """whisper_token_to_str (whisper.h:424)."""
    return _contexts[h].vocab.token_str(int(tid))


def tokenize(h: int, text: str) -> list:
    """whisper_tokenize (whisper.h:357): returns the token ids (the C shim
    copies into the caller's buffer and applies its n_max_tokens cap)."""
    return [int(t) for t in _contexts[h].vocab.tokenize(text)]


def token_count(h: int, text: str) -> int:
    """whisper_token_count (whisper.h:365)."""
    return len(_contexts[h].vocab.tokenize(text))


# ---------------------------------------------------------------------------
# low-level compute drivers (whisper.h:262-345): pcm->mel, encode, decode,
# logits, language detect.  whisper_decode threads a 1-beam KV cache between
# calls on the handle, mirroring the reference's stateful decoder.
# ---------------------------------------------------------------------------

def _obj(h: int):
    """Resolve a handle to its context OR state (handles never collide —
    one global counter); states are cloned contexts, so every step-by-step
    compute entry point works on either."""
    return _contexts.get(h) if h in _contexts else _states.get(h)


def pcm_to_mel(h: int, samples: np.ndarray) -> int:
    """whisper_pcm_to_mel (whisper.h:262)."""
    ctx = _obj(h)
    if ctx is None:
        return -1
    with DEVICE_LOCK:
        ctx.pcm_to_mel(np.asarray(samples, np.float32))
    return 0


def set_mel(h: int, mel_flat: np.ndarray, n_len: int, n_mel: int) -> int:
    """whisper_set_mel (whisper.h:277): caller-provided mel, row-major
    (n_mel, n_len) like the reference."""
    ctx = _obj(h)
    if ctx is None or n_mel != ctx.hp.n_mels:
        return -1
    mel = np.asarray(mel_flat, np.float32).reshape(n_mel, n_len)
    with DEVICE_LOCK:
        ctx.set_mel(mel)
    return 0


def encode(h: int, offset: int) -> int:
    """whisper_encode (whisper.h:289): runs the encoder + cross-KV
    precompute on the mel window starting at frame `offset`."""
    ctx = _obj(h)
    if ctx is None or ctx.mel is None:
        return -1
    try:
        with DEVICE_LOCK:
            ctx.encode_window(int(offset))
    except Exception:
        return -1
    return 0


def decode(h: int, tokens, n_past: int) -> int:
    """whisper_decode (whisper.h:301): single-decoder batch over `tokens`
    at positions n_past.., updating the handle's KV cache; logits retrieved
    via get_logits."""
    ctx = _obj(h)
    if ctx is None or ctx.xk is None:
        return -1
    sc = _scratch.setdefault(h, {})
    toks = np.asarray(list(tokens), np.int32)[None, :]
    try:
        with DEVICE_LOCK:
            # the context's own cache type, as its host loop takes
            if "cache" not in sc or n_past == 0:
                sc["cache"] = ctx.new_cache(1)
            # ctx.decode reads the logits back to the host
            logits, sc["cache"] = ctx.decode(toks, int(n_past), sc["cache"])
    except Exception:
        return -1
    sc["logits"] = np.asarray(logits[0], np.float32)
    return 0


def get_logits(h: int) -> np.ndarray:
    """whisper_get_logits (whisper.h:412): logits of the last decode's
    final position (n_vocab,)."""
    sc = _scratch.get(h, {})
    return sc.get("logits", np.zeros(0, np.float32))


def get_logits_bytes(h: int) -> bytes:
    """C-shim marshalling helper for whisper_get_logits."""
    return get_logits(h).astype("<f4").tobytes()


def lang_auto_detect(h: int, offset_ms: int) -> int:
    """whisper_lang_auto_detect (whisper.h:334): returns the top language
    id; per-language probs retrievable via get_lang_probs."""
    from .decoding.full import lang_auto_detect as _detect

    ctx = _obj(h)
    if ctx is None or ctx.mel is None:
        return -1
    try:
        with DEVICE_LOCK:
            lid, probs = _detect(ctx, int(offset_ms))
    except Exception:
        return -1
    _scratch.setdefault(h, {})["lang_probs"] = probs
    ctx.lang_id = lid
    return lid


def get_lang_probs_bytes(h: int) -> bytes:
    """Marshals the last lang_auto_detect's per-language probabilities
    (f32, lang_max_id+1 entries) for the C shim to copy out."""
    sc = _scratch.get(h, {})
    probs = sc.get("lang_probs")
    if probs is None:
        probs = np.zeros(lang_max_id() + 1, np.float32)
    return np.asarray(probs, "<f4").tobytes()


def full_default_params_json(strategy: int) -> str:
    """whisper_full_default_params_by_ref (whisper.h:587) — the defaults as
    a JSON object of whisper_full_params field names, editable and passed
    back to full()."""
    import dataclasses

    from .decoding.params import SamplingStrategy, TranscribeParams

    p = TranscribeParams.default(
        SamplingStrategy.BEAM_SEARCH if strategy == 1
        else SamplingStrategy.GREEDY)
    out = {"strategy": int(strategy),
           "greedy.best_of": p.greedy.best_of,
           "beam_search.beam_size": p.beam_search.beam_size}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, (bool, int, float, str)) and f.name != "strategy":
            out[f.name] = v
    return json.dumps(out)


# ---------------------------------------------------------------------------
# VAD surface (whisper_vad_*, whisper.h:699-756): standalone Silero-VAD
# segment detection over PCM samples.
# ---------------------------------------------------------------------------

def vad_init_from_file(path: str) -> int:
    """whisper_vad_init_from_file_with_params (whisper.h:711) at the
    port's default VAD context params (use_gpu true: the CUDA card; 0
    without one, as for a whisper context)."""
    return vad_init_from_file_with_cparams(path, None)


def vad_init_from_file_with_cparams(path: str,
                                    cparams_json: Optional[str]) -> int:
    """whisper_vad_init_from_file_with_params with its
    whisper_vad_context_params (use_gpu, default true, and gpu_device
    choose the device, as for a whisper context)."""
    from .models.vad.silero import VadContext

    device = _device(json.loads(cparams_json) if cparams_json else {},
                     "whisper_vad_init")
    if device is None:
        return 0
    try:
        with DEVICE_LOCK:
            ctx = VadContext.from_file(path, device=device)
    except Exception:
        return 0
    h = next(_handle)
    _contexts[h] = ctx
    return h


def vad_free(h: int) -> None:
    _contexts.pop(h, None)
    _scratch.pop(h, None)


def _vad_params_from_json(params_json: Optional[str]):
    from .decoding.params import VadParams

    vp = VadParams()
    for key, val in (json.loads(params_json) if params_json else {}).items():
        if hasattr(vp, key):
            setattr(vp, key, val)
    return vp


# whisper_vad_segments handles (whisper.h:733-750): the reference returns
# an allocated struct whisper_vad_segments* freed by
# whisper_vad_free_segments; here each result is its own handle
_vad_segments: Dict[int, list] = {}


def vad_segments_from_samples(h: int, params_json: Optional[str],
                              samples: np.ndarray) -> int:
    """whisper_vad_segments_from_samples (whisper.h:739): detect + segment;
    returns a segments HANDLE (0 on error) for the accessors below, freed
    by vad_free_segments — the reference's whisper_vad_segments* shape."""
    from .models.vad.silero import segments_from_probs

    ctx = _contexts.get(h)
    if ctx is None:
        return 0
    try:
        vp = _vad_params_from_json(params_json)
        with DEVICE_LOCK:
            ctx.reset_state()
            probs = ctx.detect_speech(np.asarray(samples, np.float32))
        segs = segments_from_probs(np.asarray(probs), vp)
    except Exception:
        return 0
    sh = next(_handle)
    _vad_segments[sh] = segs
    return sh


def vad_segments_n_segments(sh: int) -> int:
    return len(_vad_segments.get(sh, []))


def vad_segments_get_segment_t0(sh: int, i: int) -> float:
    """In centiseconds, like the reference (whisper.h:746 'probably
    best to use 1/100th of a second')."""
    return float(_vad_segments[sh][i].start)


def vad_segments_get_segment_t1(sh: int, i: int) -> float:
    return float(_vad_segments[sh][i].end)


def vad_free_segments(sh: int) -> None:
    """whisper_vad_free_segments (whisper.h:750)."""
    _vad_segments.pop(sh, None)


# ---- built-in microbenchmarks (whisper.h:756-759) --------------------------

def _bench_capture(fn) -> str:
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            fn()
    except Exception as e:  # noqa: BLE001 — the str variants never throw
        return f"bench failed: {e}\n"
    return buf.getvalue()


def bench_memcpy_str() -> str:
    from .cli.bench_cli import bench_memcpy

    return _bench_capture(bench_memcpy)


def bench_ggml_mul_mat_str() -> str:
    from .cli.bench_cli import bench_mul_mat

    return _bench_capture(bench_mul_mat)


# ---------------------------------------------------------------------------
# state-variant step-by-step API (whisper.h:265-316, 338, 415): the reference
# runs these on a caller-owned whisper_state; our states are cloned contexts,
# so each forwards to the shared implementation with the state handle.
# ---------------------------------------------------------------------------

def pcm_to_mel_with_state(h: int, sh: int, samples: np.ndarray) -> int:
    """whisper_pcm_to_mel_with_state (whisper.h:265)."""
    return pcm_to_mel(sh, samples)


def set_mel_with_state(h: int, sh: int, mel_flat: np.ndarray,
                       n_len: int, n_mel: int) -> int:
    """whisper_set_mel_with_state (whisper.h:281)."""
    return set_mel(sh, mel_flat, n_len, n_mel)


def encode_with_state(h: int, sh: int, offset: int) -> int:
    """whisper_encode_with_state (whisper.h:293)."""
    return encode(sh, offset)


def decode_with_state(h: int, sh: int, tokens, n_past: int) -> int:
    """whisper_decode_with_state (whisper.h:306)."""
    return decode(sh, tokens, n_past)


def get_logits_bytes_from_state(sh: int) -> bytes:
    """whisper_get_logits_from_state (whisper.h:417)."""
    return get_logits_bytes(sh)


def lang_auto_detect_with_state(h: int, sh: int, offset_ms: int) -> int:
    """whisper_lang_auto_detect_with_state (whisper.h:341)."""
    return lang_auto_detect(sh, offset_ms)


def get_lang_probs_bytes_from_state(sh: int) -> bytes:
    return get_lang_probs_bytes(sh)


def n_len_from_state(sh: int) -> int:
    """whisper_n_len_from_state (whisper.h:321): mel frames in the state."""
    state = _states.get(sh)
    mel = getattr(state, "mel", None) if state is not None else None
    return 0 if mel is None else int(mel.shape[-1])


# ---------------------------------------------------------------------------
# remaining from_state segment/token accessors (whisper.h:700-745)
# ---------------------------------------------------------------------------

def full_get_token_text_from_state(h: int, sh: int, i: int, j: int) -> str:
    """whisper_full_get_token_text_from_state (whisper.h:730)."""
    ctx = _contexts[h]
    return ctx.vocab.token_str(_state_segments[sh][i].tokens[j].id)


def full_get_token_t0_from_state(sh: int, i: int, j: int) -> int:
    return int(_state_segments[sh][i].tokens[j].t0)


def full_get_token_t1_from_state(sh: int, i: int, j: int) -> int:
    return int(_state_segments[sh][i].tokens[j].t1)


def full_get_token_data_json_from_state(sh: int, i: int, j: int) -> str:
    """whisper_full_get_token_data_from_state (whisper.h:734) — struct
    crosses the FFI as JSON, like full_get_token_data_json."""
    import dataclasses

    return json.dumps(dataclasses.asdict(_state_segments[sh][i].tokens[j]))


# ---------------------------------------------------------------------------
# VAD segments recorded by whisper_full (whisper.h:686-698): the original
# start/end ticks of the speech segments the prefilter kept
# (state->vad_segments, src/whisper.cpp:6759-6776, :8158-8180)
# ---------------------------------------------------------------------------

def _vad_used(obj) -> list:
    return list(getattr(obj, "vad_segments_used", None) or [])


def full_n_vad_segments(h: int) -> int:
    return len(_vad_used(_contexts.get(h)))


def full_get_vad_segment_t0(h: int, i: int) -> int:
    return int(_vad_used(_contexts[h])[i][0])


def full_get_vad_segment_t1(h: int, i: int) -> int:
    return int(_vad_used(_contexts[h])[i][1])


def full_n_vad_segments_from_state(sh: int) -> int:
    return len(_vad_used(_states.get(sh)))


def full_get_vad_segment_t0_from_state(sh: int, i: int) -> int:
    return int(_vad_used(_states[sh])[i][0])


def full_get_vad_segment_t1_from_state(sh: int, i: int) -> int:
    return int(_vad_used(_states[sh])[i][1])


# ---------------------------------------------------------------------------
# low-level VAD probability API (whisper.h:717-742): detect_speech fills a
# per-chunk probability buffer on the vad context, segments_from_probs
# consumes it (both already power vad_segments_from_samples above)
# ---------------------------------------------------------------------------

def vad_detect_speech(h: int, samples: np.ndarray, reset: bool = True) -> int:
    """whisper_vad_detect_speech (whisper.h:719): returns 1 on success like
    the reference's bool; probs via vad_probs.  reset=False is the
    _no_reset variant (streaming: LSTM h/c carry across calls)."""
    ctx = _contexts.get(h)
    if ctx is None:
        return 0
    try:
        with DEVICE_LOCK:
            ctx.detect_speech(np.asarray(samples, np.float32),
                              reset=bool(reset))
    except Exception:
        return 0
    return 1


def vad_n_probs(h: int) -> int:
    """whisper_vad_n_probs (whisper.h:729)."""
    ctx = _contexts.get(h)
    probs = getattr(ctx, "probs", None) if ctx is not None else None
    return 0 if probs is None else int(len(probs))


def vad_probs_bytes(h: int) -> bytes:
    """whisper_vad_probs (whisper.h:732) — f32 buffer for the shim."""
    ctx = _contexts.get(h)
    probs = getattr(ctx, "probs", None) if ctx is not None else None
    if probs is None:
        return b""
    return np.asarray(probs, "<f4").tobytes()


def vad_reset_state(h: int) -> None:
    """whisper_vad_reset_state (whisper.h:726)."""
    ctx = _contexts.get(h)
    if ctx is not None:
        with DEVICE_LOCK:
            ctx.reset_state()


def vad_segments_from_probs(h: int, params_json: Optional[str]) -> int:
    """whisper_vad_segments_from_probs (whisper.h:734): segment the probs
    from the last detect_speech; returns a segments handle (0 on error),
    accessors shared with vad_segments_from_samples."""
    from .models.vad.silero import segments_from_probs as _segs

    ctx = _contexts.get(h)
    probs = getattr(ctx, "probs", None) if ctx is not None else None
    if probs is None:
        return 0
    try:
        segs = _segs(np.asarray(probs), _vad_params_from_json(params_json))
    except Exception:
        return 0
    sh = next(_handle)
    _vad_segments[sh] = segs
    return sh


# ---------------------------------------------------------------------------
# whisper_log_set (whisper.h:584): C callback sink for framework log lines
# ---------------------------------------------------------------------------

_log_sink_keepalive: list = []


def log_set_c_sink(fn_ptr: int, user_data: int) -> None:
    """Install a C log callback: fn_ptr is a
    `void (*)(int level, const char * text, void * user_data)` address
    (ggml_log_callback shape; levels match ggml_log_level: NONE=0 DEBUG=1
    INFO=2 WARN=3 ERROR=4 == runtime.logging.LogLevel).  0 restores the
    stderr default."""
    import ctypes

    from .runtime.logging import log_set

    _log_sink_keepalive.clear()
    if not fn_ptr:
        log_set(None)
        return
    cb_t = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_void_p)
    cb = cb_t(fn_ptr)
    ud = ctypes.c_void_p(user_data)

    def sink(level, text):
        cb(int(level), text.encode("utf-8", "replace"), ud)

    _log_sink_keepalive.extend([cb, ud, sink])
    log_set(sink)


# ---------------------------------------------------------------------------
# remaining whisper.h surface (whisper.h:116-129, 210-246, 370, 438-447):
# context-params init variants, full language names, timings struct
# ---------------------------------------------------------------------------

def _apply_cparams(h: int, cparams_json: Optional[str]) -> int:
    """Apply whisper_context_params' DTW fields to a fresh handle
    (whisper.h:121-128 -> runtime.context.enable_dtw); use_gpu and
    gpu_device acted at init (`_device`), and flash_attn has no knob here
    (the attention routes are chosen as in the JAX package)."""
    if not cparams_json:
        return h
    cp = json.loads(cparams_json)
    if h and cp.get("dtw_token_timestamps"):
        # whisper_alignment_heads_preset enum order (whisper.h:88-104)
        presets = [None, "n_top_most", "custom", "tiny.en", "tiny",
                   "base.en", "base", "small.en", "small", "medium.en",
                   "medium", "large-v1", "large-v2", "large-v3",
                   "large-v3-turbo"]
        idx = int(cp.get("dtw_aheads_preset", 0))
        try:
            if idx == 1:
                _contexts[h].enable_dtw(n_top_most=int(cp.get("dtw_n_top", 0)))
            elif idx == 2:
                heads = [tuple(x) for x in cp.get("dtw_aheads", [])]
                _contexts[h].enable_dtw(custom=heads)
            elif 3 <= idx < len(presets):
                _contexts[h].enable_dtw(preset=presets[idx])
        except Exception:
            free(h)
            return 0  # reference returns NULL when aheads_masks_init fails
    return h


def init_from_file_with_cparams(path: str, cparams_json: Optional[str]) -> int:
    """whisper_init_from_file_with_params (whisper.h:210): the context on
    the device its params choose, then their DTW fields."""
    cp = json.loads(cparams_json) if cparams_json else {}
    return _apply_cparams(_init(path, cp), cparams_json)


def init_from_buffer_with_cparams(data: bytes,
                                  cparams_json: Optional[str]) -> int:
    """whisper_init_from_buffer_with_params (whisper.h:216)."""
    return _from_buffer(
        data, lambda path: init_from_file_with_cparams(path, cparams_json))


def lang_str_full(i: int) -> str:
    """whisper_lang_str_full (whisper.h:370): "english", not "en"."""
    from .decoding.languages import lang_str_full as _lf

    return _lf(i) or ""


def get_timings_packed(h: int) -> bytes:
    """whisper_get_timings (whisper.h:445): struct whisper_timings
    {float sample_ms, encode_ms, decode_ms, batchd_ms, prompt_ms} packed
    little-endian (whisper_get_timings, src/whisper.cpp: 1e-3 * t_*_us)."""
    import struct as _struct

    ctx = _obj(h)
    t = ctx.timings if ctx is not None else None
    if t is None:
        return b"\0" * 20
    return _struct.pack("<5f", 1e-3 * t.t_sample_us, 1e-3 * t.t_encode_us,
                        1e-3 * t.t_decode_us, 1e-3 * t.t_batchd_us,
                        1e-3 * t.t_prompt_us)


def _token_packed(tok) -> bytes:
    import struct as _struct

    return _struct.pack("<2i4f3qf", tok.id, tok.tid, tok.p, tok.plog,
                        tok.pt, tok.ptsum, tok.t0, tok.t1, tok.t_dtw,
                        tok.vlen)


def full_get_token_data_packed(h: int, i: int, j: int) -> bytes:
    """whisper_full_get_token_data (whisper.h:734): the exact POD fields,
    packed little-endian for the shim to memcpy into the C struct."""
    return _token_packed(_segments[h][i].tokens[j])


def full_get_token_data_packed_from_state(sh: int, i: int, j: int) -> bytes:
    return _token_packed(_state_segments[sh][i].tokens[j])


def vad_init_from_buffer(data: bytes) -> int:
    """whisper_vad_init_with_params' model_loader path (whisper.h:712):
    the shim drains the loader into memory and initializes from bytes."""
    return _from_buffer(data, vad_init_from_file)


def vad_init_from_buffer_with_cparams(data: bytes,
                                      cparams_json: Optional[str]) -> int:
    """vad_init_from_buffer with whisper_vad_context_params."""
    return _from_buffer(
        data, lambda path: vad_init_from_file_with_cparams(path, cparams_json))


# ---------------------------------------------------------------------------
# Parakeet half of the ABI (include/parakeet.h): the C shim calls through
# this module's namespace, so re-export the pk_* handle functions here.
# ---------------------------------------------------------------------------

from .capi_parakeet import *  # noqa: F401,F403,E402
