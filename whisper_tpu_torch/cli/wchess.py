"""Voice chess (reference: examples/wchess) — speak moves, the grammar for
each position constrains decoding to currently legal squares.

Audio comes from a file or raw PCM on stdin (see cli/stream.py).  Both
players move by voice, like the reference's wchess.cmd.

Port of whisper_tpu/cli/wchess.py: the same loop over the port's
WhisperContext and transcribe(), on the CUDA card; -ng runs it on the
CPU (the reference tool's --no-gpu).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..audio.energy_vad import vad_simple
from ..decoding import grammar_parser
from ..decoding.full import transcribe
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.context import WhisperContext
from ..utils.chess import Chessboard
from .stream import FileAudioSource, SAMPLE_RATE, StdinAudioSource


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wchess")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--stdin", choices=["s16", "f32"], default=None)
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("-cms", "--command-ms", type=int, default=5000)
    ap.add_argument("--grammar-penalty", type=float, default=100.0)
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    args = ap.parse_args(argv)

    ctx = WhisperContext.from_file(args.model,
                                  device="cpu" if args.no_gpu else None)
    if args.file:
        source = FileAudioSource(args.file, 30000,
                                 realtime=not args.no_realtime)
    elif args.stdin:
        source = StdinAudioSource(args.stdin, 30000)
    else:
        print("error: no audio source (use --file or --stdin)",
              file=sys.stderr)
        return 1

    board = Chessboard()
    print(board.stringify())
    print("say a move like 'knight to f3' or 'e2 e4' ...", file=sys.stderr)

    t_last = time.monotonic()
    while not source.done:
        source.poll()
        if (time.monotonic() - t_last) < 2.0:
            time.sleep(0.01)
            continue
        probe = source.get(2000)
        if not (len(probe) and vad_simple(probe, SAMPLE_RATE, 1000,
                                          args.vad_thold, args.freq_thold)):
            if source.done:
                break
            time.sleep(0.01)
            continue
        t_last = time.monotonic()
        pcm = source.get(args.command_ms)

        gbnf = board.grammar()
        if not gbnf:
            print("game over (no legal moves)")
            break
        parsed = grammar_parser.parse(gbnf)

        params = TranscribeParams.default(SamplingStrategy.GREEDY)
        params.print_progress = False
        params.single_segment = True
        params.no_timestamps = True
        params.max_tokens = 32
        params.temperature = 0.0
        params.temperature_inc = 0.0
        params.grammar_rules = parsed.rules
        params.i_start_rule = parsed.start_rule_id("root")
        params.grammar_penalty = args.grammar_penalty
        segments = transcribe(ctx, params, pcm)
        heard = "".join(s.text for s in segments).strip()
        side = "White" if board.turn == "w" else "Black"
        print(f"{side} said: '{heard}'")
        res = board.process(heard)
        if res:
            print(f"move: \033[1m{res}\033[0m")
            print(board.stringify())
        else:
            print("(not a legal move, try again)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
