"""Parakeet half of the C ABI bridge (include/parakeet.h:1-342).

Handle-table functions the embedded-CPython shim (native/whisper_abi.cpp)
forwards the parakeet_* C entry points to.  Same conventions as capi.py:
integer handles stand in for the opaque C pointers (0 == NULL), params
cross as a JSON object of parakeet_full_params field names, and C function
pointers cross as integer addresses wrapped in ctypes trampolines.

Context vs state follows the reference exactly: a parakeet_context owns a
default state (here: the ParakeetContext itself), and parakeet_init_state
forks additional states that share the device weights
(ParakeetContext.fork_state).  The *_no_state init variants return the
same handle — with XLA there is no separately-allocated compute state to
defer, so the distinction is a no-op (documented divergence).

Port of whisper_tpu/capi_parakeet.py over the port's ParakeetContext:
parakeet_context_params' `use_gpu` (default true) and `gpu_device` choose
the device at init, as whisper_context_params do (capi.py `_device`); with
no card and use_gpu true, init returns 0.
"""

from __future__ import annotations

import itertools
import json
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from .models.parakeet.context import FullParams, ParakeetContext
from .models.parakeet.tokenizer import piece_to_text

_pk_contexts: Dict[int, ParakeetContext] = {}
_pk_states: Dict[int, ParakeetContext] = {}
_pk_handle = itertools.count(1)


def _target(h: int, sh: int) -> Optional[ParakeetContext]:
    """sh=0 -> the context's default state (the context itself)."""
    if sh:
        return _pk_states.get(sh) if h == 0 or h in _pk_contexts else None
    return _pk_contexts.get(h)


# ---- lifecycle (parakeet.h:82-102) ----------------------------------------

def pk_init_from_file(path: str, cparams_json: Optional[str] = None) -> int:
    """parakeet_init_from_file_with_params: 0 on failure (NULL context).
    context_params.use_gpu / gpu_device choose the device (recorded on the
    context too)."""
    from .capi import _device

    try:
        cp = json.loads(cparams_json) if cparams_json else {}
    except ValueError:
        return 0
    device = _device(cp, "parakeet_init")
    if device is None:
        return 0
    try:
        ctx = ParakeetContext.from_file(path, device=device)
    except Exception:
        return 0
    if cparams_json:
        ctx.context_params = cp
    h = next(_pk_handle)
    _pk_contexts[h] = ctx
    return h


def pk_init_from_buffer(data: bytes, cparams_json: Optional[str] = None) -> int:
    """parakeet_init_from_buffer_with_params."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".bin")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(bytes(data))
        return pk_init_from_file(path, cparams_json)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def pk_free(h: int) -> None:
    _pk_contexts.pop(h, None)


def pk_init_state(h: int) -> int:
    """parakeet_init_state: a decode state sharing the context weights."""
    ctx = _pk_contexts.get(h)
    if ctx is None:
        return 0
    sh = next(_pk_handle)
    _pk_states[sh] = ctx.fork_state()
    return sh


def pk_free_state(sh: int) -> None:
    _pk_states.pop(sh, None)


# ---- mel / encode (parakeet.h:104-146) -------------------------------------

def pk_pcm_to_mel(h: int, sh: int, samples: np.ndarray) -> int:
    t = _target(h, sh)
    if t is None:
        return -1
    try:
        t.pcm_to_mel(np.asarray(samples, np.float32))
    except Exception:
        return -1
    return 0


def pk_set_mel(h: int, sh: int, data: np.ndarray, n_len: int,
               n_mel: int) -> int:
    t = _target(h, sh)
    if t is None or n_mel != t.hp.n_mels:
        return -1  # reference: n_mel must match the model (parakeet.h:117)
    t.set_mel(np.asarray(data, np.float32).reshape(n_len, n_mel))
    return 0


def pk_encode(h: int, sh: int, offset: int) -> int:
    t = _target(h, sh)
    if t is None:
        return -1
    return t.encode_only(offset)


# ---- tokenizer (parakeet.h:148-190) ----------------------------------------

def pk_tokenize(h: int, text: str) -> Optional[List[int]]:
    ctx = _pk_contexts.get(h)
    if ctx is None:
        return None
    return [int(x) for x in ctx.tokenize(text)]


def pk_token_count(h: int, text: str) -> int:
    toks = pk_tokenize(h, text)
    return -1 if toks is None else len(toks)


def pk_token_to_str(h: int, token: int) -> Optional[str]:
    ctx = _pk_contexts.get(h)
    if ctx is None or not (0 <= token < len(ctx.vocab.id_to_token)):
        return None
    return ctx.vocab.id_to_token[token]


def pk_token_to_text(token_str: str, is_first: bool) -> str:
    """parakeet_token_to_text: pure SentencePiece piece -> display text
    transform (src/parakeet.cpp:3403; no context needed)."""
    return piece_to_text(token_str, bool(is_first))


def pk_token_blank(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return -1 if ctx is None else ctx.vocab.token_blank


def pk_token_unk(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return -1 if ctx is None else ctx.vocab.token_unk


def pk_token_bos(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return -1 if ctx is None else ctx.vocab.token_bos


# ---- introspection (parakeet.h:163-176) ------------------------------------

def pk_n_len(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.n_len()


def pk_n_len_from_state(sh: int) -> int:
    st = _pk_states.get(sh)
    return 0 if st is None else st.n_len()


def pk_n_vocab(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_vocab


def pk_n_audio_ctx(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_audio_ctx


def pk_model_n_audio_state(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_audio_state


def pk_model_n_audio_head(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_audio_head


def pk_model_n_audio_layer(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_audio_layer


def pk_model_n_mels(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.n_mels


def pk_model_ftype(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.hp.ftype


# ---- logits (parakeet.h:177-183) -------------------------------------------

def pk_n_logits_rows(h: int, sh: int) -> int:
    t = _target(h, sh)
    if t is None or t.last_logits is None:
        return 0
    return int(t.last_logits.shape[0])


def pk_n_logits_cols(h: int, sh: int) -> int:
    t = _target(h, sh)
    if t is None:
        return 0
    # n_vocab + blank + durations, like state->logits rows
    # (src/parakeet.cpp:2396)
    return t.hp.n_joint_out


def pk_get_logits_bytes(h: int, sh: int) -> bytes:
    t = _target(h, sh)
    if t is None or t.last_logits is None:
        return b""
    return np.ascontiguousarray(t.last_logits, np.float32).tobytes()


# ---- timings / info (parakeet.h:195-208) -----------------------------------

def pk_get_timings_packed(h: int) -> bytes:
    """struct parakeet_timings {float sample_ms, encode_ms, decode_ms}."""
    ctx = _pk_contexts.get(h)
    if ctx is None:
        return struct.pack("<3f", 0.0, 0.0, 0.0)
    return struct.pack("<3f", ctx.t_mel_us / 1000.0,
                       ctx.t_encode_us / 1000.0, ctx.t_decode_us / 1000.0)


def pk_print_timings(h: int) -> None:
    ctx = _pk_contexts.get(h)
    if ctx is not None:
        from .runtime.logging import log_info

        log_info(ctx.print_timings() + "\n")


def pk_reset_timings(h: int) -> None:
    ctx = _pk_contexts.get(h)
    if ctx is not None:
        ctx.t_mel_us = ctx.t_encode_us = ctx.t_decode_us = 0


def pk_system_info() -> str:
    from .capi import system_info

    return system_info()


def pk_version() -> str:
    from . import __version__

    return __version__


# ---- full params + callbacks (parakeet.h:210-297) ---------------------------

_PK_DEFAULTS = {
    "strategy": 0,        # PARAKEET_SAMPLING_GREEDY
    "n_threads": 4,       # accepted, XLA owns threading
    "offset_ms": 0,
    "duration_ms": 0,
    "no_context": True,
    "audio_ctx": 0,
}


def pk_full_default_params_json(strategy: int) -> str:
    """parakeet_full_default_params (src/parakeet.cpp:3526-3548)."""
    d = dict(_PK_DEFAULTS)
    d["strategy"] = int(strategy)
    return json.dumps(d)


def _pk_params_from_json(spec: Optional[str]) -> FullParams:
    p = FullParams()
    if spec:
        for k, v in json.loads(spec).items():
            if hasattr(p, k):
                setattr(p, k, v)
    return p


_c_pk_token_data = None  # lazy ctypes.Structure mirroring parakeet_token_data


def _ctypes_pk_token_data():
    global _c_pk_token_data
    if _c_pk_token_data is None:
        import ctypes

        class CPkTokenData(ctypes.Structure):
            # include/parakeet.h:54-68 field order (48-byte stride)
            _fields_ = [("id", ctypes.c_int32),
                        ("duration_idx", ctypes.c_int32),
                        ("duration_value", ctypes.c_int32),
                        ("frame_index", ctypes.c_int32),
                        ("p", ctypes.c_float), ("plog", ctypes.c_float),
                        ("t0", ctypes.c_int64), ("t1", ctypes.c_int64),
                        ("is_word_start", ctypes.c_bool)]

        _c_pk_token_data = CPkTokenData
    return _c_pk_token_data


def _fill_pk_token_struct(dst, td) -> None:
    dst.id = int(td.id)
    dst.duration_idx = int(td.duration_idx)
    dst.duration_value = int(td.duration_value)
    dst.frame_index = int(td.frame_index)
    dst.p = float(td.p)
    dst.plog = float(td.plog)
    dst.t0 = int(td.t0)
    dst.t1 = int(td.t1)
    dst.is_word_start = bool(td.is_word_start)


def _pk_install_c_callbacks(p: FullParams, h: int, sh: int,
                            cb_json: Optional[str], keepalive: list) -> None:
    """Wire parakeet.h's five C function pointers (new_segment / new_token /
    progress / encoder_begin / abort; parakeet.h:210-236) onto FullParams."""
    import ctypes

    cbs = json.loads(cb_json) if cb_json else {}

    if cbs.get("new_segment"):
        ns_fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p)(
            cbs["new_segment"])
        ns_ud = ctypes.c_void_p(cbs.get("new_segment_ud", 0))
        p.new_segment_callback = lambda ctx, seg: ns_fn(h, sh, 1, ns_ud)
        keepalive.extend([ns_fn, ns_ud])

    if cbs.get("new_token"):
        CTok = _ctypes_pk_token_data()
        nt_fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.POINTER(CTok), ctypes.c_void_p)(
            cbs["new_token"])
        nt_ud = ctypes.c_void_p(cbs.get("new_token_ud", 0))

        def new_token(ctx, td):
            rec = CTok()
            _fill_pk_token_struct(rec, td)
            nt_fn(h, sh, ctypes.byref(rec), nt_ud)

        p.new_token_callback = new_token
        keepalive.extend([nt_fn, nt_ud])

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
        ab_fn = ctypes.CFUNCTYPE(ctypes.c_bool, ctypes.c_void_p)(cbs["abort"])
        ab_ud = ctypes.c_void_p(cbs.get("abort_ud", 0))
        p.abort_callback = lambda: bool(ab_fn(ab_ud))
        keepalive.extend([ab_fn, ab_ud])


def pk_full(h: int, sh: int, params_json: Optional[str],
            cb_json: Optional[str], samples: np.ndarray) -> int:
    """parakeet_full / parakeet_full_with_state (sh=0 -> default state)."""
    t = _target(h, sh)
    if t is None:
        return -1
    try:
        p = _pk_params_from_json(params_json)
        keepalive: list = []
        _pk_install_c_callbacks(p, h, sh, cb_json, keepalive)
        # capture for parakeet_get_logits, but restore afterwards: leaking
        # True onto a shared context makes every later pure-Python decode
        # read the joint's rows back
        prev = t.capture_logits
        t.capture_logits = True
        try:
            return t.full(np.asarray(samples, np.float32)
                          if samples is not None else None, p)
        finally:
            t.capture_logits = prev
    except Exception:
        return -2


def pk_chunk(h: int, sh: int, params_json: Optional[str],
             cb_json: Optional[str], samples: Optional[np.ndarray]) -> int:
    """parakeet_chunk (persistent LSTM/token state across calls)."""
    t = _target(h, sh)
    if t is None:
        return -1
    try:
        p = _pk_params_from_json(params_json)
        keepalive: list = []
        _pk_install_c_callbacks(p, h, sh, cb_json, keepalive)
        prev = t.capture_logits
        t.capture_logits = True
        if p.no_context:
            t.reset_state()
        try:
            return t.chunk(np.asarray(samples, np.float32)
                           if samples is not None and len(samples) else None,
                           p)
        finally:
            t.capture_logits = prev
    except Exception:
        return -2


# ---- segment / token accessors (parakeet.h:299-338) -------------------------

def pk_full_n_segments(h: int) -> int:
    ctx = _pk_contexts.get(h)
    return 0 if ctx is None else ctx.n_segments()


def pk_full_n_segments_from_state(sh: int) -> int:
    st = _pk_states.get(sh)
    return 0 if st is None else st.n_segments()


def _seg(h: int, sh: int, i: int):
    t = _target(h, sh)
    if t is None or not (0 <= i < len(t.result_all)):
        return None
    return t.result_all[i]


def pk_full_get_segment_t0(h: int, sh: int, i: int) -> int:
    s = _seg(h, sh, i)
    return -1 if s is None else int(s.t0)


def pk_full_get_segment_t1(h: int, sh: int, i: int) -> int:
    s = _seg(h, sh, i)
    return -1 if s is None else int(s.t1)


def pk_full_get_segment_text(h: int, sh: int, i: int) -> str:
    s = _seg(h, sh, i)
    return "" if s is None else s.text


def pk_full_n_tokens(h: int, sh: int, i: int) -> int:
    s = _seg(h, sh, i)
    return 0 if s is None else len(s.tokens)


def pk_full_get_token_id(h: int, sh: int, i: int, j: int) -> int:
    s = _seg(h, sh, i)
    if s is None or not (0 <= j < len(s.tokens)):
        return -1
    return int(s.tokens[j].id)


def pk_full_get_token_text(h: int, sh: int, i: int, j: int) -> str:
    ctx = _pk_contexts.get(h)
    s = _seg(h, sh, i)
    if ctx is None or s is None or not (0 <= j < len(s.tokens)):
        return ""
    return ctx.vocab.id_to_token[int(s.tokens[j].id)]


def pk_full_get_token_p(h: int, sh: int, i: int, j: int) -> float:
    s = _seg(h, sh, i)
    if s is None or not (0 <= j < len(s.tokens)):
        return 0.0
    return float(s.tokens[j].p)


def pk_full_get_token_data_packed(h: int, sh: int, i: int, j: int) -> bytes:
    """parakeet_token_data by value: <4i 2f 2q ? pad> == the C struct's
    48-byte layout (include/parakeet.h:54-68)."""
    s = _seg(h, sh, i)
    if s is None or not (0 <= j < len(s.tokens)):
        return b"\x00" * 48
    td = s.tokens[j]
    return struct.pack("<4i2f2q?7x", int(td.id), int(td.duration_idx),
                       int(td.duration_value), int(td.frame_index),
                       float(td.p), float(td.plog), int(td.t0), int(td.t1),
                       bool(td.is_word_start))
