"""whisper-cli equivalent: transcribe audio files from the command line.

Port of whisper_tpu/cli/transcribe.py.  Flag names match the reference CLI
(examples/cli/cli.cpp:159-260) so scripts written against whisper-cli work
unchanged:
  python -m whisper_tpu_torch.cli.transcribe -m model.bin -f audio.wav -otxt -osrt

It runs on the CUDA card and raises without one; -ng (whisper-cli's
use_gpu=false) runs the plain PyTorch path on the CPU.  -nfa turns the
flash route off and sets WTPU_ENC_ATTN and WTPU_DECODE_ATTN to `xla`, so
the encoder and a q8 cache take the plain graphs, as in the JAX package.
-p N splits each file into N chunks whose window decodes batch natively
on the card (decoding/parallel.py, runtime/batching.py).  -vad -vm FILE
runs the Silero VAD on the card before the window loop, and -dtw PRESET
(or top:N) the DTW token timestamps after each window.  --grammar FILE
--grammar-rule NAME constrains decoding to a GBNF grammar, and --precision
ggml_cpu_f16 reproduces the reference CPU backend's f16 arithmetic (parity
mode); both step the window's tokens through the host loop.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="whisper-tpu-torch",
        description="whisper transcription on a CUDA card (PyTorch port)")
    p.add_argument("-m", "--model", default="models/ggml-base.en.bin")
    p.add_argument("-f", "--file", dest="files", action="append", default=[])
    p.add_argument("files_pos", nargs="*", help="audio files")
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("-p", "--processors", type=int, default=1)
    p.add_argument("-ot", "--offset-t", type=int, default=0, dest="offset_t_ms")
    p.add_argument("-on", "--offset-n", type=int, default=0, dest="offset_n")
    p.add_argument("-d", "--duration", type=int, default=0, dest="duration_ms")
    p.add_argument("-mc", "--max-context", type=int, default=-1)
    p.add_argument("-ml", "--max-len", type=int, default=0)
    p.add_argument("-sow", "--split-on-word", action="store_true")
    p.add_argument("-bo", "--best-of", type=int, default=5)
    p.add_argument("-bs", "--beam-size", type=int, default=5)
    p.add_argument("-ac", "--audio-ctx", type=int, default=0)
    p.add_argument("--cross-kv-itype", default="f16", choices=["f16", "q8"],
                   help="cross-attention K/V storage: q8 halves the decode's"
                        " dominant HBM stream and per-window serving memory")
    p.add_argument("--kv-itype", default="f16", choices=["f16", "q8"],
                   help="KV-cache storage: dense f16/bf16 or int8 codes")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="capture a torch.profiler trace of the transcription "
                        "into DIR (a Chrome trace: chrome://tracing or "
                        "Perfetto)")
    p.add_argument("-dtw", "--dtw", default="",
                   help="compute token-level timestamps via DTW on the given "
                        "model's alignment heads (e.g. tiny.en, base, "
                        "large.v3); 'auto' infers from the model")
    p.add_argument("-wt", "--word-thold", type=float, default=0.01)
    p.add_argument("-et", "--entropy-thold", type=float, default=2.40)
    p.add_argument("-lpt", "--logprob-thold", type=float, default=-1.0)
    p.add_argument("-nth", "--no-speech-thold", type=float, default=0.6)
    p.add_argument("-tp", "--temperature", type=float, default=0.0)
    p.add_argument("-tpi", "--temperature-inc", type=float, default=0.2)
    p.add_argument("-fa", "--flash-attn", action="store_true", default=True,
                   help="flash attention route (default; whisper-cli"
                        " parity flag)")
    p.add_argument("-nfa", "--no-flash-attn", action="store_true",
                   help="disable the flash route and the attention kernels' "
                        "q8 decode route, keeping the plain graphs (whisper-cli "
                        "-nfa analogue)")
    p.add_argument("-ng", "--no-gpu", action="store_true",
                   help="run on the host CPU instead of the CUDA card "
                        "(whisper-cli -ng analogue)")
    p.add_argument("-tr", "--translate", action="store_true")
    p.add_argument("-di", "--diarize", action="store_true")
    p.add_argument("-tdrz", "--tinydiarize", action="store_true")
    p.add_argument("-nf", "--no-fallback", action="store_true")
    p.add_argument("-otxt", "--output-txt", action="store_true")
    p.add_argument("-ovtt", "--output-vtt", action="store_true")
    p.add_argument("-osrt", "--output-srt", action="store_true")
    p.add_argument("-olrc", "--output-lrc", action="store_true")
    p.add_argument("-ocsv", "--output-csv", action="store_true")
    p.add_argument("-oj", "--output-json", action="store_true")
    p.add_argument("-ojf", "--output-json-full", action="store_true")
    p.add_argument("-of", "--output-file", default=None)
    p.add_argument("-np", "--no-prints", action="store_true")
    p.add_argument("-ps", "--print-special", action="store_true")
    p.add_argument("-pc", "--print-colors", action="store_true")
    p.add_argument("--print-confidence", action="store_true")
    p.add_argument("-pp", "--print-progress", action="store_true")
    p.add_argument("-nt", "--no-timestamps", action="store_true")
    p.add_argument("-l", "--language", default="en")
    p.add_argument("-dl", "--detect-language", action="store_true")
    p.add_argument("--prompt", default=None)
    p.add_argument("--carry-initial-prompt", action="store_true")
    p.add_argument("-sns", "--suppress-nst", action="store_true")
    p.add_argument("--suppress-regex", default=None)
    p.add_argument("--grammar", default="",
                   help="GBNF grammar file to guide decoding")
    p.add_argument("--grammar-rule", default="",
                   help="top-level GBNF grammar rule name")
    p.add_argument("--grammar-penalty", type=float, default=100.0)
    p.add_argument("-owts", "--output-words", action="store_true")
    p.add_argument("-fp", "--font-path", default="/System/Library/Fonts/Supplemental/Courier New Bold.ttf")
    p.add_argument("--precision", default="",
                   choices=["", "default", "ggml_cpu_f16"],
                   help="numeric mode; ggml_cpu_f16 reproduces the reference "
                        "CPU backend's f16 arithmetic (docs/VERIFICATION.md)")
    p.add_argument("-debug", "--debug-mode", action="store_true")
    p.add_argument("--log-score", action="store_true")
    p.add_argument("-vad", "--vad", action="store_true")
    p.add_argument("-vm", "--vad-model", default=None)
    p.add_argument("-vt", "--vad-threshold", type=float, default=0.5)
    p.add_argument("-vspd", "--vad-min-speech-duration-ms", type=int, default=250)
    p.add_argument("-vsd", "--vad-min-silence-duration-ms", type=int, default=100)
    p.add_argument("-vmsd", "--vad-max-speech-duration-s", type=float,
                   default=float("inf"))
    p.add_argument("-vp", "--vad-speech-pad-ms", type=int, default=30)
    p.add_argument("-vo", "--vad-samples-overlap", type=float, default=0.1)
    return p


_COLORS = ["\033[38;5;196m", "\033[38;5;202m", "\033[38;5;208m",
           "\033[38;5;214m", "\033[38;5;220m", "\033[38;5;226m",
           "\033[38;5;190m", "\033[38;5;154m", "\033[38;5;118m",
           "\033[38;5;82m"]


def _print_segment(seg, args, vocab, stereo):
    from .output import estimate_diarization_speaker, to_timestamp

    line = ""
    if not args.no_timestamps:
        line += f"[{to_timestamp(seg.t0)} --> {to_timestamp(seg.t1)}]  "
    if args.diarize and stereo is not None:
        line += estimate_diarization_speaker(stereo, seg.t0, seg.t1)
    if args.print_colors:
        for t in seg.tokens:
            if not args.print_special and t.id >= vocab.token_eot:
                continue
            col = max(0, min(len(_COLORS) - 1, int(t.p ** 3 * len(_COLORS))))
            line += _COLORS[col] + vocab.token_str(t.id) + "\033[0m"
    else:
        line += seg.text
    if getattr(seg, "speaker_turn_next", False):
        line += " [SPEAKER_TURN]"
    print(line, flush=True)


def run(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    files = list(args.files) + list(args.files_pos)
    if not files:
        print("error: no input files specified", file=sys.stderr)
        return 1

    if args.no_flash_attn:
        import os

        from ..ops import attention as _att

        _att.set_flash_enabled(False)
        os.environ.setdefault("WTPU_ENC_ATTN", "xla")
        os.environ.setdefault("WTPU_DECODE_ATTN", "xla")

    import whisper_tpu_torch as wt
    from ..audio.io import load_audio
    from ..decoding.params import SamplingStrategy
    from ..decoding.languages import lang_str
    from . import output as OW

    if not args.no_prints:
        print(f"whisper_tpu_torch: loading model from '{args.model}'", file=sys.stderr)
    # cli.cpp use_gpu=false: -ng runs on the CPU; otherwise the card, and
    # the context raises when there is none
    ctx = wt.WhisperContext.from_file(args.model, device="cpu" if args.no_gpu else None,
                                      kv_itype=args.kv_itype,
                                      cross_itype=args.cross_kv_itype,
                                      precision=args.precision or None)
    if args.dtw:
        if args.dtw.startswith("top:"):
            ctx.enable_dtw(n_top_most=int(args.dtw[4:]))
        else:
            ctx.enable_dtw(args.dtw)
    if args.detect_language:
        args.language = "auto"
    if (args.language not in ("auto",) and
            not ctx.vocab.is_multilingual and args.language != "en"):
        print(f"warning: model is English-only; ignoring language "
              f"'{args.language}'", file=sys.stderr)
        args.language = "en"

    strategy = (SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                else SamplingStrategy.GREEDY)
    # note: the reference defaults to beam_size 5 => beam search unless -bs<=1
    rc = 0
    for fname in files:
        try:
            mono, stereo = load_audio(fname)
        except Exception as e:
            print(f"error: failed to read audio '{fname}': {e}", file=sys.stderr)
            rc = 1
            continue

        p = wt.TranscribeParams.default(strategy)
        p.print_progress = args.print_progress
        p.print_special = args.print_special
        p.print_timestamps = not args.no_timestamps
        p.translate = args.translate
        p.language = args.language if args.language != "auto" else None
        p.detect_language = args.detect_language
        p.n_threads = args.threads
        if args.max_context >= 0:
            p.n_max_text_ctx = args.max_context
        p.offset_ms = args.offset_t_ms
        p.duration_ms = args.duration_ms
        # cli.cpp:1227-1229: -owts/-ojf imply token timestamps, and -owts
        # with no explicit -ml defaults to 60-char karaoke lines
        p.token_timestamps = (args.output_words or args.output_json_full
                              or args.max_len > 0)
        p.thold_pt = args.word_thold
        p.max_len = (60 if args.output_words and args.max_len == 0
                     else args.max_len)
        p.split_on_word = args.split_on_word
        p.audio_ctx = args.audio_ctx
        p.suppress_regex = args.suppress_regex
        if args.grammar and args.grammar_rule:
            from ..decoding import grammar_parser

            with open(args.grammar) as gf:
                parsed = grammar_parser.parse(gf.read())
            p.grammar_rules = parsed.rules
            p.i_start_rule = parsed.start_rule_id(args.grammar_rule)
            p.grammar_penalty = args.grammar_penalty
        p.initial_prompt = args.prompt
        p.carry_initial_prompt = args.carry_initial_prompt
        p.greedy.best_of = args.best_of
        p.beam_search.beam_size = args.beam_size
        p.temperature = args.temperature
        p.temperature_inc = 0.0 if args.no_fallback else args.temperature_inc
        p.entropy_thold = args.entropy_thold
        p.logprob_thold = args.logprob_thold
        p.no_speech_thold = args.no_speech_thold
        p.no_timestamps = args.no_timestamps
        p.tdrz_enable = args.tinydiarize
        p.suppress_nst = args.suppress_nst
        p.vad = args.vad
        p.vad_model_path = args.vad_model
        p.vad_params.threshold = args.vad_threshold
        p.vad_params.min_speech_duration_ms = args.vad_min_speech_duration_ms
        p.vad_params.min_silence_duration_ms = args.vad_min_silence_duration_ms
        p.vad_params.max_speech_duration_s = args.vad_max_speech_duration_s
        p.vad_params.speech_pad_ms = args.vad_speech_pad_ms
        p.vad_params.samples_overlap = args.vad_samples_overlap
        p.model_path = args.model

        if not args.no_prints:
            n = len(mono)
            print(f"whisper_tpu_torch: processing '{fname}' "
                  f"({n} samples, {n / 16000:.1f} sec), lang = {args.language}, "
                  f"{'translate' if args.translate else 'transcribe'}",
                  file=sys.stderr)

        t0 = time.perf_counter()
        if args.processors > 1:
            from ..decoding.parallel import transcribe_parallel

            run_file = lambda: transcribe_parallel(ctx, p, mono, args.processors)
        else:
            run_file = lambda: wt.transcribe(ctx, p, mono)
        if args.profile:
            segments, trace_path = _profiled(run_file, ctx, args.profile)
        else:
            segments = run_file()
        dt = time.perf_counter() - t0
        if args.profile and not args.no_prints:
            print(f"whisper_tpu_torch: profiler trace written to {trace_path}",
                  file=sys.stderr)

        for seg in segments:
            _print_segment(seg, args, ctx.vocab, stereo)

        base = args.output_file or fname
        language = args.language if args.language != "auto" else (
            lang_str(ctx.lang_id) or "en")
        if args.output_txt:
            with open(base + ".txt", "w") as f:
                OW.write_txt(segments, f, args.diarize, stereo)
        if args.output_vtt:
            with open(base + ".vtt", "w") as f:
                OW.write_vtt(segments, f, args.diarize, stereo)
        if args.output_srt:
            with open(base + ".srt", "w") as f:
                OW.write_srt(segments, f, args.diarize, stereo, args.offset_n)
        if args.output_csv:
            with open(base + ".csv", "w") as f:
                OW.write_csv(segments, f, args.diarize, stereo)
        if args.output_lrc:
            with open(base + ".lrc", "w") as f:
                OW.write_lrc(segments, f, args.diarize, stereo)
        if args.output_words:
            import os

            with open(base + ".wts", "w") as f:
                # cli.cpp:1335 pads the video duration by 1000 samples
                OW.write_wts(segments, f, ctx.vocab, fname,
                             (len(mono) + 1000) / 16000.0, args.font_path,
                             args.diarize, stereo)
            os.chmod(base + ".wts", 0o755)
        if args.output_json or args.output_json_full:
            with open(base + ".json", "w") as f:
                OW.write_json(segments, f, ctx, p, language,
                              args.output_json_full, args.diarize, stereo)
        if args.log_score:
            with open(base + ".score.txt", "w") as f:
                OW.write_score(segments, f, ctx.vocab)

        if not args.no_prints:
            print(f"whisper_tpu_torch: transcribed {len(mono)/16000:.1f}s in "
                  f"{dt:.1f}s ({len(mono)/16000/dt:.1f}x realtime)",
                  file=sys.stderr)
            ctx.timings.print()
    return rc


def _profiled(fn, ctx, out_dir: str):
    """Run `fn` under torch.profiler (CPU, and the card when the context is
    on one) and write a Chrome trace into `out_dir`; returns (fn's result,
    the trace's path)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        result = fn()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    path = os.path.join(out_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return result, path


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
