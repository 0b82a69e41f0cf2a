"""Generate an importance matrix (imatrix) for IQ1/IQ2/IQ3 quantization.

Port of the repo's tools/make_imatrix.py: runs the whisper forward pass
EAGERLY over calibration audio with every matmul weight wrapped in a
capture shim (models/whisper/model.py CapturedWeight) that accumulates
per-input-channel sums of squared activations, then writes the llama.cpp
legacy imatrix binary (formats/imatrix.py) keyed by the FILE tensor names,
ready for `whisper-quantize --imatrix out.imatrix model.bin out.bin iq2_xxs`.

It runs on the CUDA card (-ng: the CPU), on dense f32 weights and f32
products (decoding/graphs.py full_f32: no TF32).  Every product is an
eager call, never a captured CUDA graph, which would drop the collector's
side effect.  On the card the sums stay there (`DeviceCollector`, f64):
each product adds one (in,) vector, and only the finished vectors come
back to the host; on the CPU the JAX package's Collector sums them.

Usage:
  python -m whisper_tpu_torch.cli.make_imatrix -m model.bin -f calib1.wav \\
      [calib2.wav ...] -o model.imatrix [--steps 32] [-ng]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..formats.imatrix import Collector, save_imatrix
from ..models.whisper import model as M
from ..models.whisper.convert import params_from_numpy


class DeviceCollector(Collector):
    """`Collector` for activations on the card: each product's per-column
    sums of squares accumulate in f64 there, and `ncalls` counts rows
    exactly as Collector.add does.  On the CPU the capture takes the
    JAX package's own Collector (numpy f32 sums, in its order)."""

    def add(self, names, x) -> None:
        xs = x.detach().reshape(-1, x.shape[-1])
        ss = xs.double().square().sum(0)
        for name in ([names] if isinstance(names, str) else names):
            if name in self.sums:
                self.sums[name] += ss
            else:
                self.sums[name] = ss.clone()
            self.ncalls[name] = self.ncalls.get(name, 0) + xs.shape[0]


def host_sums(collector: Collector) -> Dict[str, np.ndarray]:
    """The collector's sums as the f32 vectors save_imatrix writes."""
    return {k: v.float().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in collector.sums.items()}


# parameter key -> the file tensor names whose weights it holds
_ENC_KEYS = {
    "qkv_w": ("attn.query.weight", "attn.key.weight", "attn.value.weight"),
    "o_w": ("attn.out.weight",),
    "mlp0_w": ("mlp.0.weight",),
    "mlp1_w": ("mlp.2.weight",),
}
_DEC_KEYS = {
    **_ENC_KEYS,
    "xq_w": ("cross_attn.query.weight",),
    "xk_w": ("cross_attn.key.weight",),
    "xv_w": ("cross_attn.value.weight",),
    "xo_w": ("cross_attn.out.weight",),
}


def build_captured_params(model, collector, device):
    """Dense f32 parameter tree on `device` with every quantizable matmul
    weight wrapped.

    The fused q/k/v projections share one input activation, so their three
    file tensor names record the same statistics, exactly what a per-tensor
    capture of the unfused reference graph would produce."""
    params = params_from_numpy(model.params, device)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    params = f32(params)
    hp = model.hparams

    def wrap(part, keys, fmt, n_layer):
        for key, fnames in keys.items():
            names = [[fmt % (i,) + "." + f for f in fnames] for i in range(n_layer)]
            part[key] = M.CapturedWeight(names, part[key], collector)

    wrap(params["enc"]["blocks"], _ENC_KEYS, "encoder.blocks.%d", hp.n_audio_layer)
    wrap(params["dec"]["blocks"], _DEC_KEYS, "decoder.blocks.%d", hp.n_text_layer)
    params["dec"]["tok_embd"] = M.CapturedWeight(
        ["decoder.token_embedding.weight"], params["dec"]["tok_embd"], collector)
    return params


def capture(model, files, steps: int, device, log=print) -> Collector:
    """The forward passes of tools/make_imatrix.py over `files`: each 30 s
    window encoded, its cross K/V computed, then up to `steps` greedy
    decode steps from SOT, every product recorded."""
    from ..audio.io import load_audio
    from ..audio.mel import LogMel
    from ..decoding.graphs import DEVICE_LOCK, full_f32

    hp = model.hparams
    collector = DeviceCollector() if device.type == "cuda" else Collector()
    mel_fn = LogMel(model.filters.data)
    with DEVICE_LOCK, (full_f32() if device.type == "cuda"
                       else contextlib.nullcontext()):
        params = build_captured_params(model, collector, device)
        for path in files:
            pcm, _ = load_audio(path)
            mel, n_len = mel_fn(pcm)
            n_windows = max(1, (n_len + 2 * hp.n_audio_ctx - 1)
                            // (2 * hp.n_audio_ctx))
            for w in range(n_windows):
                seek = w * 2 * hp.n_audio_ctx
                window = np.zeros((hp.n_mels, 2 * hp.n_audio_ctx), np.float32)
                i1 = min(seek + 2 * hp.n_audio_ctx, mel.shape[1])
                if i1 > seek:
                    window[:, : i1 - seek] = mel[:, seek:i1]
                enc = M.encode(params, torch.from_numpy(window).to(device), hp,
                               dtype=torch.float32)
                xk, xv = M.compute_cross_kv(params, enc, hp, dtype=torch.float32)
                cache = M.new_cache(hp, 1, torch.float32, device=device)
                tok = model.vocab.token_sot
                for step in range(steps):
                    logits, cache = M.decode_step(
                        params, torch.tensor([[tok]], device=device),
                        torch.tensor([[step]], device=device), step, cache, xk, xv,
                        hp, dtype=torch.float32)
                    tok = int(logits[0, -1].argmax())
                    if tok == model.vocab.token_eot:
                        break
                log(f"{path}: window {w + 1}/{n_windows} captured", flush=True)
    return collector


def main(argv=None) -> int:
    from ..models.whisper.load import load_model
    from ..runtime.context import resolve_device

    ap = argparse.ArgumentParser(prog="make-imatrix")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--files", nargs="+", required=True,
                    help="calibration audio files (wav)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--steps", type=int, default=32,
                    help="greedy decode steps captured per window")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.no_gpu else None)
    model = load_model(args.model)
    t0 = time.perf_counter()
    collector = capture(model, args.files, args.steps, device)
    t_capture = time.perf_counter() - t0
    save_imatrix(args.output, host_sums(collector), collector.ncalls,
                 input_desc=" ".join(args.files))
    print(f"wrote {args.output}: {len(collector.sums)} tensors "
          f"(capture {t_capture:.3f} s on {device.type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
