"""Live microphone capture — audio_async analogue (examples/common-sdl.cpp).

The reference captures with SDL2: a callback thread continuously appends to a
ring buffer of the last `length_ms` of audio while the main thread
transcribes.  The load-bearing property is that capture NEVER pauses while
inference runs — a poll-based source drops samples during a slow decode.

This module reproduces that with a background reader thread feeding a
lock-protected ring buffer, over pluggable capture backends (no SDL on a TPU
host):

  * ``sounddevice`` (PortAudio) when importable — in-process callback stream,
    closest to the reference's SDL callback;
  * a capture subprocess emitting raw s16le/f32le PCM on stdout — auto-probes
    ``arecord``/``pw-record``/``parecord``/``ffmpeg``/``sox``, or any
    user-supplied command via ``mic_cmd`` (also how CI tests drive a fake
    microphone deterministically).

Device enumeration mirrors ``audio_async::init(capture_id, ...)``'s device
listing (common-sdl.cpp SDL_GetNumAudioDevices loop).
"""

from __future__ import annotations

import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

SAMPLE_RATE = 16000


def list_capture_devices() -> List[str]:
    """Names of available capture devices (empty when no backend exists)."""
    try:
        import sounddevice as sd

        return [d["name"] for d in sd.query_devices()
                if d.get("max_input_channels", 0) > 0]
    except Exception:
        pass
    for probe, args in (("arecord", ["-L"]), ("pw-record", ["--list-targets"])):
        if shutil.which(probe):
            try:
                out = subprocess.run([probe] + args, capture_output=True,
                                     text=True, timeout=10).stdout
                return [ln for ln in out.splitlines()
                        if ln and not ln.startswith(" ")]
            except Exception:
                continue
    return []


def _default_capture_cmd(device: Optional[str]) -> Optional[List[str]]:
    """First available CLI recorder, emitting s16le 16 kHz mono on stdout."""
    dev = device
    if shutil.which("arecord"):
        cmd = ["arecord", "-q", "-f", "S16_LE", "-r", str(SAMPLE_RATE),
               "-c", "1", "-t", "raw"]
        if dev:
            cmd += ["-D", dev]
        return cmd
    if shutil.which("pw-record"):
        cmd = ["pw-record", "--rate", str(SAMPLE_RATE), "--channels", "1",
               "--format", "s16", "-"]
        if dev:
            cmd += ["--target", dev]
        return cmd
    if shutil.which("parecord"):
        cmd = ["parecord", "--raw", f"--rate={SAMPLE_RATE}", "--channels=1",
               "--format=s16le"]
        if dev:
            cmd += [f"--device={dev}"]
        return cmd
    if shutil.which("ffmpeg"):
        return ["ffmpeg", "-loglevel", "quiet", "-f", "alsa",
                "-i", dev or "default", "-ar", str(SAMPLE_RATE), "-ac", "1",
                "-f", "s16le", "-"]
    if shutil.which("sox"):
        return ["sox", "-q", "-d", "-t", "raw", "-r", str(SAMPLE_RATE),
                "-e", "signed", "-b", "16", "-c", "1", "-"]
    return None


class MicCapture:
    """Threaded ring buffer over a live capture backend.

    API mirrors audio_async (common-sdl.cpp): ``resume``/``pause``/``clear``,
    ``get(ms)`` returns the newest ``ms`` of audio.  The reader thread keeps
    consuming while the caller is busy, so no samples are lost to inference
    latency — the ring simply overwrites audio older than ``length_ms``.
    """

    def __init__(self, length_ms: int, device: Optional[str] = None,
                 mic_cmd: Optional[Sequence[str]] = None,
                 fmt: str = "s16"):
        self.n_keep = SAMPLE_RATE * length_ms // 1000
        self._buf = np.zeros(0, np.float32)
        self._lock = threading.Lock()
        self._running = False
        self._paused = False
        self.done = False
        self._proc: Optional[subprocess.Popen] = None
        self._sd_stream = None
        self._thread: Optional[threading.Thread] = None
        self._device = device
        self._mic_cmd = list(mic_cmd) if mic_cmd else None
        self._fmt = fmt

    # -- backend bring-up ---------------------------------------------------

    def start(self) -> None:
        if self._mic_cmd is None and self._try_sounddevice():
            self._running = True
            return
        cmd = self._mic_cmd or _default_capture_cmd(self._device)
        if cmd is None:
            raise RuntimeError(
                "no capture backend: install sounddevice, or provide "
                "arecord/pw-record/parecord/ffmpeg/sox on PATH, or pass "
                "an explicit capture command")
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL)
        self._thread = threading.Thread(target=self._pump_proc, daemon=True)
        self._running = True
        self._thread.start()

    def _try_sounddevice(self) -> bool:
        try:
            import sounddevice as sd
        except Exception:
            return False

        def cb(indata, frames, t, status):  # noqa: ARG001 (PortAudio sig)
            self._append(np.asarray(indata[:, 0], np.float32))

        try:
            self._sd_stream = sd.InputStream(
                samplerate=SAMPLE_RATE, channels=1, dtype="float32",
                device=self._device, callback=cb)
            self._sd_stream.start()
            return True
        except Exception:
            self._sd_stream = None
            return False

    def _pump_proc(self) -> None:
        bytes_per = 2 if self._fmt == "s16" else 4
        chunk_n = SAMPLE_RATE // 20 * bytes_per  # 50 ms reads
        assert self._proc is not None and self._proc.stdout is not None
        while self._running:
            data = self._proc.stdout.read(chunk_n)
            if not data:
                self.done = True
                break
            if self._fmt == "s16":
                x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            else:
                x = np.frombuffer(data, "<f4").astype(np.float32)
            self._append(x)

    # -- audio_async surface ------------------------------------------------

    def _append(self, samples: np.ndarray) -> None:
        if self._paused:
            return
        with self._lock:
            self._buf = np.concatenate([self._buf, samples])[-self.n_keep:]

    def resume(self) -> None:
        self._paused = False

    def pause(self) -> None:
        self._paused = True

    def clear(self) -> None:
        with self._lock:
            self._buf = np.zeros(0, np.float32)

    def get(self, ms: int) -> np.ndarray:
        n = SAMPLE_RATE * ms // 1000
        with self._lock:
            return self._buf[-n:].copy()

    def available_ms(self) -> int:
        with self._lock:
            return len(self._buf) * 1000 // SAMPLE_RATE

    def stop(self) -> None:
        self._running = False
        if self._sd_stream is not None:
            try:
                self._sd_stream.stop()
                self._sd_stream.close()
            except Exception:
                pass
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "MicCapture":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
