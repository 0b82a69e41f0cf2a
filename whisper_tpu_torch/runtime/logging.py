"""Levelled logging + system info (whisper_log_set /
whisper_print_system_info analogues, src/whisper.cpp:9166-9203, :4339).

Port of whisper_tpu/runtime/logging.py: the log levels and callback are
the same; the system info reports torch, CUDA and the card in place of JAX
and Pallas.

A globally settable callback receives every framework log line; the default
prints to stderr.  Modules log through `log(level, msg)`.
"""

from __future__ import annotations

import enum
import sys
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    NONE = 0
    DEBUG = 1
    INFO = 2
    WARN = 3
    ERROR = 4


_callback: Optional[Callable[[LogLevel, str], None]] = None


def _default_callback(level: LogLevel, text: str) -> None:
    if level == LogLevel.DEBUG:
        return
    sys.stderr.write(text)
    sys.stderr.flush()


def log_set(callback: Optional[Callable[[LogLevel, str], None]]) -> None:
    """whisper_log_set: install a global log callback (None restores the
    stderr default)."""
    global _callback
    _callback = callback


def log(level: LogLevel, text: str) -> None:
    (_callback or _default_callback)(level, text)


def log_info(text: str) -> None:
    log(LogLevel.INFO, text)


def log_warn(text: str) -> None:
    log(LogLevel.WARN, text)


def log_error(text: str) -> None:
    log(LogLevel.ERROR, text)


def print_system_info() -> str:
    """whisper_print_system_info: capability string for the active runtime
    (torch and CUDA versions, the card, whether nvcc can build the kernels)."""
    import torch

    from ..ops import _cuda

    parts = [f"WHISPER_TPU_TORCH : torch = {torch.__version__}",
             f"cuda = {torch.version.cuda}"]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    parts.append(f"devices = {n}")
    if n:
        parts.append(f"device0 = {torch.cuda.get_device_name(0)}")
    try:
        _cuda._nvcc()
        parts.append("NVCC = 1")
    except RuntimeError:
        parts.append("NVCC = 0")
    return " | ".join(parts)
