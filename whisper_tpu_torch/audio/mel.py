"""Log-mel spectrogram frontend: the host numpy path and the device mel.

Bit-parity target: the reference `log_mel_spectrogram`
(src/whisper.cpp:3176-3254) — periodic Hann(400), hop 160, reflect-pad 200 at
the start, 30 s of zeros + 200 at the end, power spectrum, mel filterbank dot,
`log10(max(s, 1e-10))`, global clamp to `max-8`, normalize `(x+4)/4`.

The numpy functions are copies of whisper_tpu/audio/mel.py's host path.
`_log_mel_torch` is the counterpart of its batched-rfft device mel
(`_log_mel_jax`): one `torch.fft.rfft` over all frames, f32 throughout, on
the device the `LogMel` was given (backend="torch").  backend="native" is
the JAX package's C helper (native/wtpu_native.cpp through
whisper_tpu_torch/native.py), on the host; where no compiler builds it, the
numpy path runs, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.whisper.hparams import HOP_LENGTH, N_FFT, N_SAMPLES_PER_CHUNK, SAMPLE_RATE


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (src/whisper.cpp:3029-3037)."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


def pad_audio(samples: np.ndarray) -> np.ndarray:
    """stage-2 reflect pad (200) at start; 30 s zeros + 200 at end."""
    n = len(samples)
    stage_2 = N_FFT // 2  # 200
    n_reflect = min(stage_2, max(0, n - 1))
    head = samples[1 : 1 + n_reflect][::-1]
    head = np.concatenate([np.zeros(stage_2 - n_reflect, np.float32), head])
    tail = np.zeros(N_SAMPLES_PER_CHUNK + stage_2, np.float32)
    return np.concatenate([head, samples.astype(np.float32), tail])


def mel_frame_counts(n_samples: int) -> Tuple[int, int]:
    """(n_len, n_len_org) — total padded frames and real-audio frames."""
    stage_2 = N_FFT // 2
    padded = n_samples + N_SAMPLES_PER_CHUNK + 2 * stage_2
    n_len = (padded - N_FFT) // HOP_LENGTH
    n_len_org = 1 + int((n_samples + stage_2 - N_FFT) / HOP_LENGTH)  # C trunc-div
    return n_len, n_len_org


def _log_mel_numpy(padded: np.ndarray, filters: np.ndarray, window: np.ndarray,
                   n_len: int) -> np.ndarray:
    """Host mel path: identical math, f64 mel dot like the reference's
    double-accumulating worker loop (src/whisper.cpp:3148-3160)."""
    idx = (np.arange(n_len)[:, None] * HOP_LENGTH + np.arange(N_FFT)[None, :])
    frames = padded[idx].astype(np.float32) * window[None, :]
    spec = np.fft.rfft(frames, n=N_FFT, axis=-1)
    power = (spec.real.astype(np.float32) ** 2 +
             spec.imag.astype(np.float32) ** 2)
    mel = power.astype(np.float64) @ filters.T.astype(np.float64)
    mel = np.log10(np.maximum(mel, 1e-10))
    mmax = mel.max() - 8.0
    mel = np.maximum(mel, mmax)
    return (((mel + 4.0) / 4.0).T).astype(np.float32)


def _log_mel_torch(padded: torch.Tensor, filters: torch.Tensor,
                   window: torch.Tensor, n_len: int) -> torch.Tensor:
    """padded audio -> normalized log-mel (n_mel, n_len), all f32 on the
    tensors' device (whisper_tpu/audio/mel.py `_log_mel_jax`).  The caller
    holds full-f32 products (`decoding/graphs.py full_f32`)."""
    frames = padded.unfold(0, N_FFT, HOP_LENGTH)[:n_len]   # (n_len, 400) view
    frames = frames * window[None, :]
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag   # (n_len, 201)
    mel = power @ filters.T                                 # (n_len, n_mel)
    mel = torch.log10(torch.clamp(mel, min=1e-10))
    mel = torch.maximum(mel, mel.max() - 8.0)
    return ((mel + 4.0) / 4.0).T                            # (n_mel, n_len)


class LogMel:
    """Stateful wrapper holding the filterbank; mirrors whisper_pcm_to_mel.

    backend="numpy" (default) is the reference-exact host path;
    backend="torch" runs the batched-rfft mel on `device` (default the CUDA
    card, as every entry point of the port), within ~1e-5 of max |mel| of
    the numpy mel (two f32 FFTs' rounding, amplified by the log in quiet
    bins); backend="native" runs the C helper on the host."""

    def __init__(self, filters: np.ndarray, backend: str = "numpy", device=None):
        if backend not in ("numpy", "torch", "native"):
            raise ValueError(f"unknown mel backend {backend!r}")
        self.backend = backend
        self.np_filters = np.asarray(filters, dtype=np.float32)
        self.np_window = hann_window()
        if backend == "torch":
            from ..runtime.context import resolve_device

            self.device = resolve_device(device)
            self.filters = torch.from_numpy(self.np_filters).to(self.device)
            self.window = torch.from_numpy(self.np_window).to(self.device)
        self.n_mel = int(filters.shape[0])

    def __call__(self, samples: np.ndarray) -> Tuple[np.ndarray, int]:
        """Returns (mel[n_mel, n_len] float32 numpy, n_len_org)."""
        n_len, n_len_org = mel_frame_counts(len(samples))
        padded = pad_audio(np.asarray(samples, dtype=np.float32))
        if self.backend == "torch":
            from ..decoding.graphs import DEVICE_LOCK, full_f32

            with DEVICE_LOCK, full_f32():
                mel = _log_mel_torch(torch.from_numpy(padded).to(self.device),
                                     self.filters, self.window, n_len)
                return mel.cpu().numpy(), n_len_org
        if self.backend == "native":
            from .. import native

            mel = native.log_mel(padded, self.np_filters, N_FFT, HOP_LENGTH,
                                 n_len)
            if mel is not None:
                return mel, n_len_org
        return _log_mel_numpy(padded, self.np_filters, self.np_window, n_len), n_len_org
