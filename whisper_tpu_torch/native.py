"""ctypes bindings for the native C++ runtime components (native/).

The reference implements its host-side runtime (mel frontend, quant codecs)
in C/C++; this framework does the same for the paths that stay on the host —
built lazily with the system toolchain and cached, with transparent numpy
fallbacks when no compiler is available.

Set WTPU_NATIVE=0 to force the numpy paths.

Port of whisper_tpu/native.py: the same unchanged native/wtpu_native.cpp,
built with native/Makefile into whisper_tpu_torch/build/ (a temporary
directory there, then renamed into place, so processes that build at once
never load a half-written library).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_LIB_PATH = Path(__file__).resolve().parent / "build" / "libwtpu_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_LIB_PATH.parent) as tmp:
        try:
            r = subprocess.run(["make", "-C", str(_NATIVE_DIR), f"BUILD={tmp}"],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode != 0:
            return False
        os.replace(Path(tmp) / _LIB_PATH.name, _LIB_PATH)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    if os.environ.get("WTPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _LIB_PATH.exists() and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.wtpu_native_version.restype = ctypes.c_char_p
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        for name in ("q4_0", "q5_0", "q8_0"):
            q = getattr(lib, f"wtpu_quantize_{name}")
            q.argtypes = [f32p, ctypes.c_int64, u8p]
            d = getattr(lib, f"wtpu_dequantize_{name}")
            d.argtypes = [u8p, ctypes.c_int64, f32p]
        lib.wtpu_log_mel.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, f32p]
        _lib = lib
        return _lib


_BLOCK_BYTES = {"q4_0": 18, "q5_0": 22, "q8_0": 34}


def quantize(name: str, x: np.ndarray) -> Optional[bytes]:
    lib = get_lib()
    if lib is None or name not in _BLOCK_BYTES:
        return None
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 32 == 0
    out = np.zeros(x.size // 32 * _BLOCK_BYTES[name], np.uint8)
    getattr(lib, f"wtpu_quantize_{name}")(x, x.size, out)
    return out.tobytes()


def dequantize(name: str, buf: bytes, n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None or name not in _BLOCK_BYTES:
        return None
    raw = np.frombuffer(buf, np.uint8).copy()
    out = np.zeros(n + (-n) % 32, np.float32)
    getattr(lib, f"wtpu_dequantize_{name}")(raw, out.size, out)
    return out[:n]


def log_mel(padded: np.ndarray, filters: np.ndarray, n_fft: int, hop: int,
            n_len: int) -> Optional[np.ndarray]:
    """Native whisper log-mel over pre-padded audio; (n_mel, n_len) or None."""
    lib = get_lib()
    if lib is None:
        return None
    padded = np.ascontiguousarray(padded, np.float32)
    filters = np.ascontiguousarray(filters, np.float32)
    n_mel = filters.shape[0]
    out = np.zeros((n_mel, n_len), np.float32)
    lib.wtpu_log_mel(padded, padded.size, filters, n_mel, n_fft, hop,
                     n_len, out)
    return out
