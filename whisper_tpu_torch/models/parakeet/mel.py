"""Parakeet log-mel frontend (reference: src/parakeet.cpp:2719-2905).

Differs from whisper's mel: preemphasis 0.97, centered ZERO padding of
n_fft/2, trained analysis window (center-placed if shorter than n_fft),
power spectrum (|X|^2, not magnitude), natural log with eps 5.96e-08, and
per-mel-bin mean/std normalization computed over the valid frames only
(ddof=1, denom std + 1e-5) but applied to all frames.

Port of whisper_tpu/models/parakeet/mel.py.  `log_mel_spectrogram` is a
copy of its numpy path (the reference-exact one); `log_mel_spectrogram_torch`
is the counterpart of its device mel (`log_mel_spectrogram_jax`): the same
math as one `torch.fft.rfft` over all frames, f32 throughout, on the device
it is given.  Torch compiles nothing per shape, so it runs at the exact
length instead of the JAX package's power-of-two sample buckets.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .hparams import HOP_LENGTH

LOG_EPS = 5.960464477539063e-08
NORM_EPS = 1e-5


def log_mel_spectrogram(samples: np.ndarray, filters: np.ndarray,
                        window: np.ndarray, n_fft: int,
                        hop: int = HOP_LENGTH) -> np.ndarray:
    """Returns mel of shape (n_len, n_mel) matching the reference layout
    (time-major, mel.data[i*n_mel + j])."""
    x = np.asarray(samples, np.float32).copy()
    n_samples = len(x)
    n_mel, n_fb = filters.shape
    assert n_fb == n_fft // 2 + 1

    # preemphasis x[i] -= 0.97 x[i-1] (original x[i-1]; :2814-2820)
    if n_samples > 1:
        x[1:] -= 0.97 * x[:-1].copy()

    # centered constant padding (:2823-2825)
    pad = n_fft // 2
    padded = np.concatenate([np.zeros(pad, np.float32), x,
                             np.zeros(pad, np.float32)])

    n_len = (len(padded) - n_fft) // hop + 1
    win_size = len(window) if len(window) else n_fft
    wpad = (n_fft - win_size) // 2

    # frame extraction with the window placed at the center of the FFT buffer
    idx = np.arange(n_len)[:, None] * hop + np.arange(win_size)[None, :] + wpad
    frames = np.zeros((n_len, n_fft), np.float32)
    frames[:, wpad:wpad + win_size] = padded[idx] * window[None, :]

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)

    mel = np.log(power @ filters.T.astype(np.float32) + LOG_EPS)

    # per-bin normalization over valid frames only (:2860-2885)
    valid = max(2, min(n_samples // hop, n_len))
    mean = mel[:valid].mean(axis=0)
    std = mel[:valid].std(axis=0, ddof=1)
    mel = (mel - mean[None, :]) / (std + NORM_EPS)[None, :]
    return mel.astype(np.float32)


def log_mel_spectrogram_torch(samples: np.ndarray, filters: torch.Tensor,
                              window: torch.Tensor, n_fft: int,
                              hop: int = HOP_LENGTH) -> torch.Tensor:
    """The numpy path's math on the device of `filters` (n_mel, n_fb) and
    `window`: returns the (n_len, n_mel) f32 mel there.  The caller holds
    DEVICE_LOCK and full-f32 products (decoding/graphs.py full_f32)."""
    dev = filters.device
    x = torch.from_numpy(np.asarray(samples, np.float32)).to(dev)
    n_samples = x.shape[0]
    # preemphasis on the ORIGINAL x[i-1]
    x = torch.cat([x[:1], x[1:] - 0.97 * x[:-1]])
    pad = n_fft // 2
    padded = F.pad(x, (pad, pad))
    n_len = (padded.shape[0] - n_fft) // hop + 1
    win_size = window.shape[0] if window.shape[0] else n_fft
    wpad = (n_fft - win_size) // 2
    # the window sits at the centre of the FFT buffer, zeros around it
    frames = padded[wpad:].unfold(0, win_size, hop)[:n_len] * window[None, :]
    frames = F.pad(frames, (wpad, n_fft - win_size - wpad))
    spec = torch.fft.rfft(frames, n=n_fft, dim=1)
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = torch.log(power @ filters.T + LOG_EPS)
    valid = max(2, min(n_samples // hop, n_len))
    mean = mel[:valid].mean(dim=0)
    std = mel[:valid].std(dim=0, correction=1)
    return (mel - mean[None, :]) / (std + NORM_EPS)[None, :]
