"""parakeet-cli analogue (reference: examples/parakeet-cli/parakeet-cli.cpp).

Port of whisper_tpu/cli/parakeet_cli.py: the same flags and output.  It
runs on the CUDA card; -ng runs on the CPU.

Usage: python -m whisper_tpu_torch.cli.parakeet_cli -m model.bin -f audio.wav
"""

from __future__ import annotations

import argparse
import sys

from ..audio.io import load_audio
from ..models.parakeet.context import FullParams, ParakeetContext
from ..models.parakeet.tokenizer import piece_to_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parakeet-cli")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", dest="files", action="append", default=[])
    ap.add_argument("-t", "--threads", type=int, default=4)
    ap.add_argument("-ps", "--print-segments", action="store_true")
    ap.add_argument("-otxt", "--output-txt", action="store_true")
    ap.add_argument("-of", "--output-file", default="")
    ap.add_argument("-np", "--no-prints", action="store_true")
    ap.add_argument("--batch", action="store_true",
                    help="transcribe all input files in one batched device "
                         "call (one encoder batch + one TDT loop)")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the host CPU instead of the CUDA card "
                         "(parakeet-cli -ng analogue)")
    ap.add_argument("-dev", "--device", type=int, default=0,
                    help="accepted for parakeet-cli argv compatibility; the "
                         "runtime uses one card")
    ap.add_argument("files_pos", nargs="*", default=[])
    args = ap.parse_args(argv)

    files = args.files + args.files_pos
    if not files:
        print("error: no input files specified", file=sys.stderr)
        return 2

    if not args.no_prints:
        print(f"Loading Parakeet model from: {args.model}", file=sys.stderr)
    try:
        ctx = ParakeetContext.from_file(args.model,
                                        device="cpu" if args.no_gpu else None)
    except (ValueError, OSError) as e:
        print(f"error: failed to load Parakeet model from '{args.model}': {e}",
              file=sys.stderr)
        return 3

    if args.batch and len(files) > 1:
        all_samples = [load_audio(f)[0] for f in files]
        results = ctx.full_batch(all_samples,
                                 FullParams(n_threads=args.threads))
        for fname, segs in zip(files, results):
            text = "".join(s.text for s in segs)
            print(text)
            if args.print_segments and not args.no_prints:
                for i, seg in enumerate(segs):
                    print(f"segment {i}: [{seg.t0} -> {seg.t1}] {seg.text}",
                          file=sys.stderr)
            if args.output_txt:
                out = fname + ".txt"
                with open(out, "w") as fo:
                    fo.write(text + "\n")
                if not args.no_prints:
                    print(f"saving output to '{out}'", file=sys.stderr)
        if not args.no_prints:
            print(ctx.print_timings(), file=sys.stderr)
        return 0

    for fname in files:
        samples, _ = load_audio(fname)

        def token_cb(_ctx, td, _first=[True]):
            text = piece_to_text(ctx.token_to_str(td.id), _first[0])
            if text:
                _first[0] = False
            print(text, end="", flush=True)

        params = FullParams(n_threads=args.threads,
                            new_token_callback=token_cb)
        if ctx.full(samples, params) != 0:
            print(f"error: failed to process '{fname}'", file=sys.stderr)
            return 10
        print()

        if args.print_segments and not args.no_prints:
            for i in range(ctx.n_segments()):
                seg = ctx.get_segment(i)
                print(f"segment {i}: [{seg.t0} -> {seg.t1}] {seg.text}",
                      file=sys.stderr)
        if args.output_txt:
            out = (args.output_file or fname) + ".txt"
            with open(out, "w") as fo:
                fo.write(ctx.full_text() + "\n")
            if not args.no_prints:
                print(f"saving output to '{out}'", file=sys.stderr)
        if not args.no_prints:
            print(ctx.print_timings(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
