"""Build the port's C ABI: the shim native/whisper_abi.cpp as
`build/libwhisper_tpu_torch.so`, and C or C++ hosts linked against it.

The shim embeds CPython and forwards whisper.h's and parakeet.h's calls to
`whisper_tpu_torch.capi`; native/whisper_tpu.h and native/parakeet_tpu.h
(the JAX package's headers) declare its surface.  Everything builds with
the host's g++/gcc at first use, into a temporary file renamed into place,
so processes that build at once never load a half-written file.  The
library builds again when the shim's source or this interpreter's libpython
changes (a stamp beside it records both), a host when its source, a header
or the library is newer than it.  Nothing runs at import.

    from whisper_tpu_torch import abi
    lib = abi.build_library()
    exe = abi.build_host(abi.REPO / "native" / "test_abi_main.c")
    subprocess.run([exe, model, pcm], env=abi.host_env())

A host started as its own process embeds a fresh interpreter, which must
find this package and torch: `host_env()` puts the repo and this
interpreter's site-packages on PYTHONPATH.  Loaded with ctypes into a
running interpreter (`load_library`), the shim uses that one (its
Py_IsInitialized branch): `ContextParams`, `FullParams`, `VadContextParams`
and `VadParams` are whisper.h's structs as native/whisper_tpu.h lays them
out, so the init calls, whisper_full and whisper_vad_segments_from_samples
take them by value.  `seg_lines` reads the `[t0 -> t1] text` lines a host
prints.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import site
import subprocess
import sys
import sysconfig
from pathlib import Path
from typing import Optional, Sequence

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
BUILD = PKG / "build"
SHIM = PKG / "native" / "whisper_abi.cpp"
LIB = BUILD / "libwhisper_tpu_torch.so"
HEADERS = REPO / "native"
# the JSON full params of the hosts' greedy run (whisper_full_default_params
# with language "en" and no temperature fallback)
GREEDY = '{"language": "en", "temperature_inc": 0.0}'
SEG_LINE = re.compile(r"^\[(-?\d+) -> (-?\d+)\] (.*?)(?: \|((?: -?\d+)*))?$")


def _python_link() -> list:
    """Include and link flags of this interpreter's libpython."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-I{inc}", f"-L{libdir}", f"-l{pyver}", f"-Wl,-rpath,{libdir}"]


def _stale(out: Path, sources: Sequence[Path]) -> bool:
    return (not out.exists()
            or any(out.stat().st_mtime < s.stat().st_mtime for s in sources))


def _compile(cmd_head: list, out: Path, tail: list) -> None:
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([*cmd_head, "-o", str(tmp), *tail], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {out.name} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)


def build_library() -> Path:
    """libwhisper_tpu_torch.so from the shim (g++ -shared -fPIC against this
    interpreter's libpython)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    flags = _python_link()
    stamp = LIB.with_name(LIB.name + ".stamp")
    want = hashlib.sha256(SHIM.read_bytes() + " ".join(flags).encode()).hexdigest()
    if not LIB.exists() or not stamp.exists() or stamp.read_text() != want:
        _compile(["g++", "-shared", "-fPIC", "-O2", str(SHIM)], LIB, flags)
        stamp.write_text(want)
    return LIB


def build_host(src: Path, name: Optional[str] = None) -> Path:
    """An executable from one C (gcc) or C++ (g++, C++17) host source,
    against native/'s headers (and bindings/cpp's for a C++ host), linked
    to libwhisper_tpu_torch.so."""
    src = Path(src)
    lib = build_library()
    out = BUILD / (name or src.stem)
    if _stale(out, [src, lib, *HEADERS.glob("*.h")]):
        cxx = src.suffix == ".cpp"
        head = (["g++", "-std=c++17", "-O2", f"-I{REPO / 'bindings' / 'cpp'}"] if cxx
                else ["gcc", "-O2", "-Wall", "-Werror"])
        _compile([*head, f"-I{HEADERS}", str(src)], out,
                 [f"-L{BUILD}", "-lwhisper_tpu_torch", f"-Wl,-rpath,{BUILD}"])
    return out


def host_env(**extra: str) -> dict:
    """The environment of a host process: PYTHONPATH holds the repo and this
    interpreter's site-packages, so the embedded interpreter imports this
    package and the same torch."""
    paths = [str(REPO), *site.getsitepackages()]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths))
    env.update(extra)
    return env


class ContextParams(ctypes.Structure):
    """struct whisper_context_params (native/whisper_tpu.h)."""

    _fields_ = [("use_gpu", ctypes.c_bool), ("flash_attn", ctypes.c_bool),
                ("gpu_device", ctypes.c_int), ("dtw_token_timestamps", ctypes.c_bool),
                ("dtw_aheads_preset", ctypes.c_int), ("dtw_n_top", ctypes.c_int),
                ("dtw_aheads_n_heads", ctypes.c_size_t), ("dtw_aheads_heads", ctypes.c_void_p),
                ("dtw_mem_size", ctypes.c_size_t)]


class VadContextParams(ctypes.Structure):
    """struct whisper_vad_context_params (native/whisper_tpu.h)."""

    _fields_ = [("n_threads", ctypes.c_int), ("use_gpu", ctypes.c_bool),
                ("gpu_device", ctypes.c_int)]


class VadParams(ctypes.Structure):
    """whisper_vad_params (native/whisper_tpu.h)."""

    _fields_ = [("threshold", ctypes.c_float), ("min_speech_duration_ms", ctypes.c_int),
                ("min_silence_duration_ms", ctypes.c_int),
                ("max_speech_duration_s", ctypes.c_float), ("speech_pad_ms", ctypes.c_int),
                ("samples_overlap", ctypes.c_float)]


_B, _I, _F, _P = ctypes.c_bool, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class FullParams(ctypes.Structure):
    """struct whisper_full_params (native/whisper_tpu.h), its greedy and
    beam_search members flattened (same offsets); the five callbacks and
    their user data as addresses."""

    _fields_ = (
        [("strategy", _I), ("n_threads", _I), ("n_max_text_ctx", _I), ("offset_ms", _I),
         ("duration_ms", _I)]
        + [(n, _B) for n in ("translate", "no_context", "no_timestamps", "single_segment",
                             "print_special", "print_progress", "print_realtime",
                             "print_timestamps", "token_timestamps")]
        + [("thold_pt", _F), ("thold_ptsum", _F), ("max_len", _I), ("split_on_word", _B),
           ("max_tokens", _I), ("debug_mode", _B), ("audio_ctx", _I), ("tdrz_enable", _B),
           ("suppress_regex", ctypes.c_char_p), ("initial_prompt", ctypes.c_char_p),
           ("carry_initial_prompt", _B), ("prompt_tokens", _P), ("prompt_n_tokens", _I),
           ("language", ctypes.c_char_p), ("detect_language", _B), ("suppress_blank", _B),
           ("suppress_nst", _B)]
        + [(n, _F) for n in ("temperature", "max_initial_ts", "length_penalty",
                             "temperature_inc", "entropy_thold", "logprob_thold",
                             "no_speech_thold")]
        + [("greedy_best_of", _I), ("beam_size", _I), ("beam_patience", _F)]
        + [(n, _P) for n in ("new_segment_callback", "new_segment_callback_user_data",
                             "progress_callback", "progress_callback_user_data",
                             "encoder_begin_callback", "encoder_begin_callback_user_data",
                             "abort_callback", "abort_callback_user_data",
                             "logits_filter_callback", "logits_filter_callback_user_data",
                             "grammar_rules")]
        + [("n_grammar_rules", ctypes.c_size_t), ("i_start_rule", ctypes.c_size_t),
           ("grammar_penalty", _F), ("vad", _B), ("vad_model_path", ctypes.c_char_p),
           ("vad_params", VadParams)])


def load_library() -> ctypes.CDLL:
    """libwhisper_tpu_torch.so loaded into this interpreter, with the
    signatures of the whisper.h calls a host makes to init, run
    whisper_full and read the segments, and to segment speech with the
    VAD."""
    lib = ctypes.CDLL(str(build_library()))
    ctx, i64 = ctypes.c_void_p, ctypes.c_int64
    sigs = {
        "whisper_full_params_sizeof": ([], ctypes.c_size_t),
        "whisper_context_default_params": ([], ContextParams),
        "whisper_init_from_file_with_params": ([ctypes.c_char_p, ContextParams], ctx),
        "whisper_full_default_params": ([_I], FullParams),
        "whisper_full": ([ctx, FullParams, ctypes.POINTER(_F), _I], _I),
        "whisper_full_n_segments": ([ctx], _I),
        "whisper_full_get_segment_t0": ([ctx, _I], i64),
        "whisper_full_get_segment_t1": ([ctx, _I], i64),
        "whisper_full_get_segment_text": ([ctx, _I], ctypes.c_char_p),
        "whisper_full_n_tokens": ([ctx, _I], _I),
        "whisper_full_get_token_id": ([ctx, _I, _I], _I),
        "whisper_free": ([ctx], None),
        "whisper_vad_default_context_params": ([], VadContextParams),
        "whisper_vad_default_params": ([], VadParams),
        "whisper_vad_init_from_file_with_params": ([ctypes.c_char_p, VadContextParams], ctx),
        "whisper_vad_segments_from_samples": ([ctx, VadParams, ctypes.POINTER(_F), _I], ctx),
        "whisper_vad_segments_n_segments": ([ctx], _I),
        "whisper_vad_segments_get_segment_t0": ([ctx, _I], _F),
        "whisper_vad_segments_get_segment_t1": ([ctx, _I], _F),
        "whisper_vad_free_segments": ([ctx], None),
        "whisper_vad_free": ([ctx], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    if lib.whisper_full_params_sizeof() != ctypes.sizeof(FullParams):
        raise RuntimeError("FullParams does not match the library's whisper_full_params")
    return lib


def segments(lib: ctypes.CDLL, ctx: int) -> list:
    """(t0, t1, text, token ids) of every segment of the last whisper_full."""
    return [(lib.whisper_full_get_segment_t0(ctx, i), lib.whisper_full_get_segment_t1(ctx, i),
             lib.whisper_full_get_segment_text(ctx, i).decode(),
             [lib.whisper_full_get_token_id(ctx, i, j)
              for j in range(lib.whisper_full_n_tokens(ctx, i))])
            for i in range(lib.whisper_full_n_segments(ctx))]


def vad_segments(lib: ctypes.CDLL, vctx: int, params: VadParams, samples) -> list:
    """(t0, t1) in centiseconds of whisper_vad_segments_from_samples."""
    import numpy as np

    buf = np.ascontiguousarray(samples, np.float32)
    sh = lib.whisper_vad_segments_from_samples(
        vctx, params, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(buf))
    if not sh:
        raise RuntimeError("whisper_vad_segments_from_samples returned NULL")
    out = [(lib.whisper_vad_segments_get_segment_t0(sh, i),
            lib.whisper_vad_segments_get_segment_t1(sh, i))
           for i in range(lib.whisper_vad_segments_n_segments(sh))]
    lib.whisper_vad_free_segments(sh)
    return out


def seg_lines(stdout: str) -> list:
    """(t0, t1, text, token ids or None) of a host's `[t0 -> t1] text` lines."""
    out = []
    for line in stdout.splitlines():
        m = SEG_LINE.match(line)
        if m:
            ids = None if m.group(4) is None else [int(x) for x in m.group(4).split()]
            out.append((int(m.group(1)), int(m.group(2)), m.group(3), ids))
    return out
