"""Build and load the hand-written Hopper kernels (csrc/*.cu).

Each source compiles on its own with nvcc into a shared library with a plain
C interface (sm_90a), loaded with ctypes.  The libraries land in
`whisper_tpu_torch/build/`, named by a hash of their sources and flags, so
the first call builds them and later processes reuse them.  All sources
build in parallel, one nvcc process each.

Nothing here runs at import time: the CPU tests import every module of the
package on a host with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
# one shared library per CUDA source
SOURCES = {
    "qmmt": "qmmt.cu",
    "decode_attn": "decode_attn.cu",
    "enc_attn": "enc_attn.cu",
    "qmm": "qmm.cu",
    "flash_attn": "flash_attn.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# per library: {"seconds": build time or 0.0 when reused, "ptxas": log}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """Named by a hash of the source, every header under csrc/ (a changed
    header rebuilds every library) and the compiler flags."""
    h = hashlib.sha256()
    for f in (CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, dict]:
    """Build every library that is not built yet, all nvcc processes at
    once; raise with the compiler's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": "(reused)",
                                         "path": str(out)})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": log,
                            "path": str(out)}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_INFO[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name` (building all sources on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        for n in SOURCES:
            if n not in _LIBS:
                _LIBS[n] = _bind(n, ctypes.CDLL(str(_lib_path(n))))
        lib = _LIBS[name]
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "qmmt": {"wtt_qmmt": [_P] * 11 + [_I] * 9 + [_F, _P],
             "wtt_qmmt_rows": [_P] * 13 + [_I] * 10 + [_F, _P]},
    "decode_attn": {"wtt_self_attend_q8": [_P, _P, _P, _I] + [_L] * 3 + [_P, _P]
                    + [_I] * 9 + [_P]},
    "enc_attn": {"wtt_self_attention_qkv": [_P, _P] + [_I] * 5 + [_P]},
    "qmm": {"wtt_qmm": [_P] * 4 + [_I] * 4 + [_P]},
    "flash_attn": {"wtt_flash_attn": [_P] * 4 + [_I] * 5 + [_L] * 8 + [_F, _P]},
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.wtt_error_string.argtypes = [ctypes.c_int]
    lib.wtt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = lib.wtt_error_string(code).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional operand)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
