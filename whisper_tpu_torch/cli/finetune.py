"""whisper-finetune: adapt a whisper checkpoint on (wav, txt) pairs.

CLI front-end for `training/finetune.py` — the capability the reference's
ggml-opt layer provides but whisper.cpp never wires to a tool.  Takes audio
files paired with transcript text files (`clip.wav` + `clip.txt`, or an
explicit TSV manifest `path<TAB>transcript`), builds teacher-forcing rows
(SOT [lang task] text EOT at the reference's prompt layout,
src/whisper.cpp:6934-6980), fine-tunes with AdamW/SGD, and writes a standard
legacy-ggml file usable by this runtime and the reference loader alike.

Usage:
  python -m whisper_tpu.cli.finetune -m base.bin -o tuned.bin data/*.wav
  python -m whisper_tpu.cli.finetune -m base.bin -o tuned.bin --manifest tsv \
      --steps 200 --lr 1e-5 --batch-size 4 --train-encoder

Port of whisper_tpu/cli/finetune.py: the same tool over the port's
training/finetune.py, on the CUDA card; -ng runs it on the CPU (the
reference tools' --no-gpu).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _build_sample(wm, mel_fn, wav_path: str, text: str, language: str,
                  max_ctx: int):
    from ..audio.io import load_audio

    mono, _stereo = load_audio(wav_path, 16000)
    mel, _n_len = mel_fn(mono)
    hp, v = wm.hparams, wm.vocab
    # fixed 30 s window (2*n_audio_ctx frames), zero-padded / truncated
    want = 2 * hp.n_audio_ctx
    m = np.zeros((hp.n_mels, want), np.float32)
    take = min(want, mel.shape[1])
    m[:, :take] = mel[:, :take]
    prompt = [v.token_sot]
    if v.is_multilingual:
        from ..decoding import languages

        lid = languages.lang_id(language)
        prompt += [v.lang_token(lid), v.token_transcribe]
    toks = prompt + v.tokenize(" " + text.strip()) + [v.token_eot]
    if len(toks) > max_ctx:
        toks = toks[: max_ctx - 1] + [v.token_eot]
    return m, np.asarray(toks, np.int32)


def _collect_pairs(paths, manifest):
    pairs = []
    if manifest:
        with open(manifest) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                wav, text = line.split("\t", 1)
                pairs.append((wav, text))
        return pairs
    for wav in paths:
        txt = os.path.splitext(wav)[0] + ".txt"
        if not os.path.exists(txt):
            raise SystemExit(f"no transcript {txt} for {wav}")
        with open(txt) as f:
            pairs.append((wav, f.read()))
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="whisper-finetune",
        description="fine-tune a whisper ggml checkpoint on (wav, txt) pairs")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("-o", "--out", required=True, help="output model file")
    ap.add_argument("audio", nargs="*", help="wav files (paired .txt)")
    ap.add_argument("--manifest", help="TSV file: wav_path<TAB>transcript")
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--optimizer", choices=("adamw", "sgd"), default="adamw")
    ap.add_argument("--train-encoder", action="store_true",
                    help="also train the encoder (default: decoder only)")
    ap.add_argument("--f32", action="store_true", help="write f32 output")
    args = ap.parse_args(argv)

    from ..audio.mel import LogMel
    from ..models.whisper.load import load_model
    from ..training.finetune import finetune, save_finetuned

    wm = load_model(args.model)
    if wm.params is None:
        raise SystemExit("header-only test model has no weights to train")
    mel_fn = LogMel(wm.filters.data)
    pairs = _collect_pairs(args.audio, args.manifest)
    if not pairs:
        raise SystemExit("no training pairs given")
    samples = [_build_sample(wm, mel_fn, w, t, args.language,
                             wm.hparams.n_text_ctx) for w, t in pairs]
    print(f"fine-tuning on {len(samples)} samples, {args.steps} steps "
          f"({args.optimizer}, lr {args.lr})", file=sys.stderr)
    params, losses = finetune(
        wm, samples, steps=args.steps, batch_size=args.batch_size,
        lr=args.lr, optimizer=args.optimizer,
        freeze_encoder=not args.train_encoder,
        log=lambda msg: print(msg, file=sys.stderr),
        device="cpu" if args.no_gpu else None)
    save_finetuned(args.out, wm, params, use_f16=not args.f32)
    print(f"wrote {args.out} (final loss {losses[-1]:.4f})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
