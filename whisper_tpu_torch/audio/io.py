"""Audio file loading (wav native; mp3/flac/ogg via optional backends).

The reference uses miniaudio + stb_vorbis (examples/common-whisper.cpp:12-145);
here 16-bit/float PCM WAV is decoded natively and other formats fall back to
soundfile/torchaudio/ffmpeg when available.  Output: float32 mono PCM in
[-1, 1] at 16 kHz, matching `read_audio_data` (stereo is downmixed by the
reference's plain channel SUM, common-whisper.cpp:64; the original stereo
pair is also returned for diarization).
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np

from ..models.whisper.hparams import SAMPLE_RATE


def _resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t = np.linspace(0.0, len(x) - 1, n_out)
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)


def read_wav(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """Returns (mono, stereo_or_none, sample_rate)."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        sr = w.getframerate()
        sw = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {sw}")
    stereo = None
    if n_ch == 2:
        data = data.reshape(-1, 2)
        stereo = data.copy()
        # reference downmix is the plain SUM l + r, no /2
        # (examples/common-whisper.cpp:64 read_audio_from_decoder)
        data = data.sum(axis=1)
    elif n_ch != 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data.astype(np.float32), stereo, sr


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load any supported audio file as (mono_16k, stereo_16k_or_none)."""
    if path.lower().endswith(".wav"):
        mono, stereo, sr = read_wav(path)
    else:
        mono, stereo, sr = _load_via_fallbacks(path)
    if sr != sample_rate:
        mono = _resample_linear(mono, sr, sample_rate)
        if stereo is not None:
            stereo = np.stack(
                [_resample_linear(stereo[:, 0], sr, sample_rate),
                 _resample_linear(stereo[:, 1], sr, sample_rate)], axis=1)
    return mono, stereo


def _load_via_fallbacks(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    try:
        import soundfile as sf  # type: ignore

        data, sr = sf.read(path, dtype="float32", always_2d=True)
        stereo = data if data.shape[1] == 2 else None
        mono = data.sum(axis=1) if data.shape[1] == 2 else data.mean(axis=1)
        return mono.astype(np.float32), stereo, sr
    except Exception:
        pass
    try:
        import torchaudio  # type: ignore

        wav, sr = torchaudio.load(path)
        data = wav.numpy().T
        stereo = data if data.shape[1] == 2 else None
        mono = data.sum(axis=1) if data.shape[1] == 2 else data.mean(axis=1)
        return mono.astype(np.float32), stereo, int(sr)
    except Exception:
        pass
    if shutil.which("ffmpeg"):
        # reference fallback: transcode with ffmpeg (examples/common-whisper.cpp)
        out = subprocess.run(
            ["ffmpeg", "-nostdin", "-i", path, "-f", "f32le", "-ac", "1",
             "-ar", str(SAMPLE_RATE), "-"],
            capture_output=True, check=True,
        ).stdout
        return np.frombuffer(out, dtype="<f4").copy(), None, SAMPLE_RATE
    raise RuntimeError(f"cannot decode audio file {path}: no backend available")


def write_wav(path: str, samples: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    pcm = np.clip(samples, -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())
