"""vad-speech-segments CLI (reference: examples/vad-speech-segments/
speech.cpp): run the Silero VAD over an audio file and print the detected
speech segments in centiseconds.

Port of whisper_tpu/cli/vad_segments.py.  The VAD runs on the CUDA card
(models/vad/silero.py VadContext) and raises without one.

Usage: python -m whisper_tpu_torch.cli.vad_segments -vm silero.bin -f audio.wav
"""

from __future__ import annotations

import argparse
import sys

from ..audio.io import load_audio
from ..decoding.params import VadParams
from ..models.vad.silero import VadContext, segments_from_samples


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="vad-speech-segments",
        description="Note: Output timestamps are in centiseconds "
                    "(1/100th of a second).")
    ap.add_argument("-f", "--file", dest="fname", default="")
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-vm", "--vad-model", required=True)
    ap.add_argument("-vt", "--vad-threshold", type=float, default=0.5)
    ap.add_argument("-vspd", "--vad-min-speech-duration-ms", type=int,
                    default=250)
    ap.add_argument("-vsd", "--vad-min-silence-duration-ms", type=int,
                    default=100)
    ap.add_argument("-vmsd", "--vad-max-speech-duration-s", type=float,
                    default=float("inf"))
    ap.add_argument("-vp", "--vad-speech-pad-ms", type=int, default=30)
    ap.add_argument("-vo", "--vad-samples-overlap", type=float, default=0.1)
    ap.add_argument("-np", "--no-prints", action="store_true")
    ap.add_argument("fname_pos", nargs="?", default="")
    args = ap.parse_args(argv)

    fname = args.fname or args.fname_pos
    if not fname:
        ap.print_help(sys.stderr)
        return 1

    try:
        samples, _ = load_audio(fname)
    except Exception as e:  # noqa: BLE001
        print(f"error: failed to read audio data from {fname}: {e}",
              file=sys.stderr)
        return 2

    try:
        vctx = VadContext.from_file(args.vad_model)
    except (ValueError, OSError) as e:
        print(f"error: failed to initialize whisper context: {e}",
              file=sys.stderr)
        return 3

    vp = VadParams(
        threshold=args.vad_threshold,
        min_speech_duration_ms=args.vad_min_speech_duration_ms,
        min_silence_duration_ms=args.vad_min_silence_duration_ms,
        max_speech_duration_s=args.vad_max_speech_duration_s,
        speech_pad_ms=args.vad_speech_pad_ms,
        samples_overlap=args.vad_samples_overlap,
    )
    segments = segments_from_samples(vctx, vp, samples)

    print()
    print(f"Detected {len(segments)} speech segments:")
    for i, seg in enumerate(segments):
        print(f"Speech segment {i}: start = {seg.start:.2f}, "
              f"end = {seg.end:.2f}")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
