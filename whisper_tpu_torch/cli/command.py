"""Voice-command assistant (reference: examples/command/command.cpp).

Three modes, as in the reference:
  * free-form: energy-VAD-triggered short transcriptions;
  * guided (--grammar): GBNF-constrained decoding with --prompt activation;
  * command-list (--commands FILE): score each allowed command by its
    teacher-forced token log-probability behind the guiding prompt
    (process_command_list, command.cpp:256-470) and pick the best.

Audio comes from a file played back in real time or raw PCM on stdin (see
cli/stream.py — the SDL microphone is replaced by these sources).

Port of whisper_tpu/cli/command.py: the same loop over the port's
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
from ..decoding.full import transcribe
from ..decoding.params import SamplingStrategy, TranscribeParams
from ..runtime.context import WhisperContext
from .stream import FileAudioSource, SAMPLE_RATE, StdinAudioSource


def read_allowed_commands(path: str) -> List[str]:
    out = []
    for line in open(path):
        line = line.strip().lower()
        if line:
            out.append(line)
    return out


def score_commands(ctx: WhisperContext, pcm: np.ndarray,
                   commands: List[str]) -> List[float]:
    """Teacher-forced log-prob of each command after the guiding prompt
    (process_command_list semantics)."""
    vocab = ctx.vocab
    prompt = "select one from the available words: " + \
        ", ".join(commands) + ". selected word: "
    prompt_tokens = vocab.tokenize(" " + prompt.strip())

    ctx.pcm_to_mel(pcm)
    ctx.encode_window(0)

    init = [vocab.token_sot]
    if vocab.is_multilingual:
        init += [vocab.lang_token(ctx.lang_id), vocab.token_transcribe]
    init += [vocab.token_not]

    def logprob(logits_row, t):
        row = np.asarray(logits_row, np.float64)
        row = row - row.max()
        p = np.exp(row)
        return float(np.log(p[t] / p.sum()))

    # decode the guiding prompt once; every command branches off it.  The
    # port's decode_step writes the cache in place, so the branches share
    # one cache: each command steps one token at a time from n_prefix and
    # writes its cell before it reads it, so no branch reads a cell that an
    # earlier branch (or the prompt's bucket padding) wrote
    base_cache = ctx.new_cache(1)
    prefix = np.asarray([init + prompt_tokens], np.int32)
    base_logits, base_cache = ctx.decode(prefix, 0, base_cache)
    n_prefix = prefix.shape[1]

    scores = []
    for cmd in commands:
        cmd_tokens = vocab.tokenize(" " + cmd)
        lp = 0.0
        logits, cache, n_past = base_logits, base_cache, n_prefix
        for t in cmd_tokens:
            lp += logprob(logits[0], t)
            logits, cache = ctx.decode(np.asarray([[t]], np.int32),
                                       n_past, cache)
            n_past += 1
        scores.append(lp / max(1, len(cmd_tokens)))
    return scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-command")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-f", "--file", default=None)
    ap.add_argument("--stdin", choices=["s16", "f32"], default=None)
    ap.add_argument("-c", "--capture", default=None,
                    help="capture device for the live microphone")
    ap.add_argument("--no-realtime", action="store_true")
    ap.add_argument("-cmd", "--commands", default="")
    ap.add_argument("--grammar", default="")
    ap.add_argument("--grammar-rule", default="root")
    ap.add_argument("--grammar-penalty", type=float, default=100.0)
    ap.add_argument("--suppress-regex", default="")
    ap.add_argument("--prompt", default="")
    ap.add_argument("--context", default="")
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    ap.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    ap.add_argument("-cms", "--command-ms", type=int, default=8000)
    args = ap.parse_args(argv)

    ctx = WhisperContext.from_file(args.model,
                                  device="cpu" if args.no_gpu else None)
    length_ms = max(args.command_ms, 30000)
    if args.file:
        source = FileAudioSource(args.file, length_ms,
                                 realtime=not args.no_realtime)
    elif args.stdin:
        source = StdinAudioSource(args.stdin, length_ms)
    else:
        from .stream import MicAudioSource

        try:
            source = MicAudioSource(length_ms, device=args.capture)
        except RuntimeError as e:
            print(f"error: {e} (use --file or --stdin)", file=sys.stderr)
            return 1

    commands = read_allowed_commands(args.commands) if args.commands else []
    grammar_rules = None
    i_start_rule = 0
    if args.grammar:
        from ..decoding import grammar_parser

        parsed = grammar_parser.parse(open(args.grammar).read())
        grammar_rules = parsed.rules
        i_start_rule = parsed.start_rule_id(args.grammar_rule)

    print("listening for commands ...", file=sys.stderr)
    t_last = time.monotonic()
    while not source.done:
        source.poll()
        now = time.monotonic()
        if (now - t_last) < 2.0:
            time.sleep(0.01)
            continue
        pcm_probe = source.get(2000)
        if len(pcm_probe) == 0 or not vad_simple(
                pcm_probe, SAMPLE_RATE, 1000, args.vad_thold, args.freq_thold):
            if source.done:
                break
            time.sleep(0.01)
            continue
        t_last = now
        pcm = source.get(args.command_ms)

        if commands:
            scores = score_commands(ctx, pcm, commands)
            best = int(np.argmax(scores))
            print(f"detected command: \033[1m{commands[best].upper()}\033[0m "
                  f"(logprob {scores[best]:.3f})")
            continue

        # the reference transcribes with BEAM_SEARCH defaults (beam 5,
        # best_of 5; examples/command/command.cpp:151,169-171)
        params = TranscribeParams.default(SamplingStrategy.BEAM_SEARCH)
        params.greedy.best_of = 5
        params.beam_search.beam_size = 5
        params.print_progress = False
        params.single_segment = True
        params.no_timestamps = True
        params.translate = False
        params.language = args.language
        params.max_tokens = args.max_tokens
        params.audio_ctx = args.audio_ctx
        params.temperature = 0.4
        params.temperature_inc = 1.0
        params.initial_prompt = args.context or None
        params.suppress_regex = args.suppress_regex or None
        if grammar_rules is not None:
            params.grammar_rules = grammar_rules
            params.i_start_rule = i_start_rule
            params.grammar_penalty = args.grammar_penalty
        segments = transcribe(ctx, params, pcm)
        text = "".join(s.text for s in segments).strip()
        if args.prompt:
            # activation-phrase mode: require the prompt prefix
            low = text.lower()
            if low.startswith(args.prompt.lower()):
                text = text[len(args.prompt):].strip(" ,.!?")
                print(f"command: \033[1m{text}\033[0m")
            else:
                print(f"(ignored: '{text}')", file=sys.stderr)
        else:
            print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
