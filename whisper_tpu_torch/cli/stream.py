"""Real-time streaming transcription (reference: examples/stream/stream.cpp).

Two modes, exactly as the reference:
  * fixed-step (--step > 0): sliding window with --keep carry-over and
    rolling prompt-token context every n_new_line iterations;
  * energy-VAD (--step <= 0): transcribe a --length window whenever
    vad_simple detects end of speech in the last 2 s.

Audio sources (SDL microphone replaced by audio/capture.py backends):
  * a live microphone (default, like the reference): threaded ring-buffer
    capture via sounddevice/arecord/pw-record/parecord/ffmpeg/sox
    (-c selects a device, --capture-list enumerates, --mic-cmd overrides
    the capture command — any program emitting raw s16le PCM on stdout);
  * a wav/audio file played back against the wall clock (--file), or
    as fast as possible with --no-realtime (useful for tests/CI);
  * raw s16le or f32le PCM on stdin (--stdin [s16|f32]).

Port of whisper_tpu/cli/stream.py: the same loop over the port's
WhisperContext and transcribe(), on the CUDA card; -ng runs it on the
CPU (the reference tool's --no-gpu).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from ..audio.energy_vad import vad_simple
from ..audio.io import load_audio
from ..decoding.full import transcribe
from ..decoding.languages import lang_id
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.context import WhisperContext
from .output import to_timestamp

SAMPLE_RATE = 16000


class AudioSource:
    """audio_async analogue (examples/common-sdl.cpp): ring buffer of the
    last `length_ms` of captured audio; get(ms) returns the newest ms."""

    def __init__(self, length_ms: int):
        self.n_keep = SAMPLE_RATE * length_ms // 1000
        self.buf = np.zeros(0, np.float32)
        self.done = False

    def _append(self, samples: np.ndarray) -> None:
        self.buf = np.concatenate([self.buf, samples])[-self.n_keep:]

    def poll(self) -> None:
        raise NotImplementedError

    def get(self, ms: int) -> np.ndarray:
        n = SAMPLE_RATE * ms // 1000
        return self.buf[-n:].copy()

    def clear(self) -> None:
        self.buf = np.zeros(0, np.float32)


class FileAudioSource(AudioSource):
    def __init__(self, path: str, length_ms: int, realtime: bool = True):
        super().__init__(length_ms)
        self.samples, _ = load_audio(path)
        self.pos = 0
        self.realtime = realtime
        self.t0 = time.monotonic()

    def poll(self) -> None:
        if self.realtime:
            target = int((time.monotonic() - self.t0) * SAMPLE_RATE)
        else:
            target = self.pos + self.n_keep // 4
        target = min(target, len(self.samples))
        if target > self.pos:
            self._append(self.samples[self.pos:target])
            self.pos = target
        if self.pos >= len(self.samples):
            self.done = True

    def available_ms(self) -> int:
        return len(self.buf) * 1000 // SAMPLE_RATE


class MicAudioSource(AudioSource):
    """Live microphone via audio.capture.MicCapture (audio_async semantics:
    a reader thread keeps the ring buffer fed while transcription runs, so
    poll() has nothing to do)."""

    def __init__(self, length_ms: int, device=None, mic_cmd=None):
        super().__init__(length_ms)
        from ..audio.capture import MicCapture

        self.cap = MicCapture(length_ms, device=device, mic_cmd=mic_cmd)
        self.cap.start()

    def poll(self) -> None:
        self.done = self.cap.done

    def get(self, ms: int) -> np.ndarray:
        return self.cap.get(ms)

    def clear(self) -> None:
        self.cap.clear()

    def available_ms(self) -> int:
        return self.cap.available_ms()

    def close(self) -> None:
        self.cap.stop()


class StdinAudioSource(AudioSource):
    def __init__(self, fmt: str, length_ms: int):
        super().__init__(length_ms)
        self.fmt = fmt

    def poll(self) -> None:
        chunk = sys.stdin.buffer.read(SAMPLE_RATE // 10 *
                                      (2 if self.fmt == "s16" else 4))
        if not chunk:
            self.done = True
            return
        if self.fmt == "s16":
            x = np.frombuffer(chunk, "<i2").astype(np.float32) / 32768.0
        else:
            x = np.frombuffer(chunk, "<f4").astype(np.float32)
        self._append(x)


def run_stream(ctx: WhisperContext, source: AudioSource, args,
               out=sys.stdout, ferr=sys.stderr) -> int:
    step_ms, length_ms = args.step, args.length
    keep_ms = min(args.keep, step_ms) if step_ms > 0 else args.keep
    length_ms = max(length_ms, step_ms)

    n_samples_step = SAMPLE_RATE * step_ms // 1000 if step_ms > 0 else 0
    n_samples_len = SAMPLE_RATE * length_ms // 1000
    n_samples_keep = SAMPLE_RATE * keep_ms // 1000

    use_vad = n_samples_step <= 0
    n_new_line = max(1, length_ms // step_ms - 1) if not use_vad else 1

    no_context = args.no_context or use_vad

    pcm_old = np.zeros(0, np.float32)
    prompt_tokens: List[int] = []
    n_iter = 0
    t_last = time.monotonic()
    t_start = t_last

    while not source.done:
        if not use_vad:
            # accumulate a full step
            while not source.done:
                source.poll()
                got = source.get(step_ms)
                if len(got) >= n_samples_step:
                    break
                time.sleep(0.001)
            pcm_new = source.get(step_ms)
            source.clear()
            if len(pcm_new) < n_samples_step // 2 and source.done:
                break
            n_take = min(len(pcm_old),
                         max(0, n_samples_keep + n_samples_len - len(pcm_new)))
            pcm = np.concatenate([pcm_old[len(pcm_old) - n_take:], pcm_new])
            pcm_old = pcm
        else:
            now = time.monotonic()
            if (now - t_last) * 1000 < 2000:
                source.poll()
                time.sleep(0.01)
                continue
            source.poll()
            pcm_new = source.get(2000)
            if len(pcm_new) and vad_simple(pcm_new, SAMPLE_RATE, 1000,
                                           args.vad_thold, args.freq_thold):
                pcm = source.get(length_ms)
                t_last = now
            elif source.done:
                break
            else:
                time.sleep(0.01)
                continue

        params = TranscribeParams.default(
            SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
            else SamplingStrategy.GREEDY)
        params.print_progress = False
        params.no_timestamps = not use_vad
        params.translate = args.translate
        params.single_segment = not use_vad
        params.max_tokens = args.max_tokens
        params.language = args.language
        params.beam_search.beam_size = args.beam_size
        params.audio_ctx = args.audio_ctx
        params.temperature_inc = 0.0 if args.no_fallback else 0.2
        params.prompt_tokens = None if no_context else list(prompt_tokens)

        segments = transcribe(ctx, params, pcm)

        if not use_vad:
            print("\33[2K\r" + " " * 100 + "\33[2K\r", end="", file=out)
        else:
            t1 = int((t_last - t_start) * 1000)
            t0 = max(0, t1 - len(pcm) * 1000 // SAMPLE_RATE)
            print(f"\n### Transcription {n_iter} START | t0 = {t0} ms | "
                  f"t1 = {t1} ms\n", file=out)

        for seg in segments:
            if params.no_timestamps:
                print(seg.text, end="", file=out)
            else:
                line = (f"[{to_timestamp(seg.t0)} --> {to_timestamp(seg.t1)}]"
                        f"  {seg.text}")
                if getattr(seg, "speaker_turn_next", False):
                    line += " [SPEAKER_TURN]"
                print(line, file=out)
        out.flush()

        if use_vad:
            print(f"\n### Transcription {n_iter} END", file=out)

        n_iter += 1
        if not use_vad and n_iter % n_new_line == 0:
            print(file=out)
            pcm_old = pcm[len(pcm) - n_samples_keep:]
            if not no_context:
                prompt_tokens = [t.id for s in segments for t in s.tokens]
    print(file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-stream")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-f", "--file", default=None,
                    help="stream from an audio file instead of a microphone")
    ap.add_argument("--stdin", choices=["s16", "f32"], default=None,
                    help="read raw PCM from stdin")
    ap.add_argument("-c", "--capture", default=None,
                    help="capture device name/id for the live microphone")
    ap.add_argument("--capture-list", action="store_true",
                    help="list capture devices and exit")
    ap.add_argument("--mic-cmd", default=None,
                    help="capture command emitting raw s16le 16kHz mono PCM "
                         "on stdout (overrides backend auto-detection)")
    ap.add_argument("--no-realtime", action="store_true",
                    help="process file audio as fast as possible")
    ap.add_argument("--step", type=int, default=3000)
    ap.add_argument("--length", type=int, default=10000)
    ap.add_argument("--keep", type=int, default=200)
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-tr", "--translate", action="store_true")
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("-bs", "--beam-size", type=int, default=-1)
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    ap.add_argument("-kc", "--keep-context", dest="no_context",
                    action="store_false", default=True)
    ap.add_argument("-nf", "--no-fallback", action="store_true")
    args = ap.parse_args(argv)

    if args.capture_list:
        from ..audio.capture import list_capture_devices

        devs = list_capture_devices()
        for i, name in enumerate(devs):
            print(f"   - Capture device #{i}: '{name}'")
        if not devs:
            print("no capture devices found", file=sys.stderr)
        return 0

    if args.language != "auto" and lang_id(args.language) == -1:
        print(f"error: unknown language '{args.language}'", file=sys.stderr)
        return 1

    ctx = WhisperContext.from_file(args.model,
                                  device="cpu" if args.no_gpu else None)
    if args.file:
        source = FileAudioSource(args.file, max(args.length, 30000),
                                 realtime=not args.no_realtime)
    elif args.stdin:
        source = StdinAudioSource(args.stdin, max(args.length, 30000))
    else:
        # live microphone — the reference's default source (stream.cpp
        # audio_async::init(params.capture_id, ...))
        import shlex

        try:
            source = MicAudioSource(
                max(args.length, 30000), device=args.capture,
                mic_cmd=shlex.split(args.mic_cmd) if args.mic_cmd else None)
        except RuntimeError as e:
            print(f"error: {e}\n(use --file or --stdin when no microphone "
                  "backend is available)", file=sys.stderr)
            return 1
    try:
        return run_stream(ctx, source, args)
    finally:
        if isinstance(source, MicAudioSource):
            source.close()


if __name__ == "__main__":
    sys.exit(main())
