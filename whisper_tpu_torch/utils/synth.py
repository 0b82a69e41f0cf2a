"""Write a complete synthetic ggml Whisper model file from a seed (numpy).

`synth_params` is the in-memory counterpart (the JAX package's
utils/synth.py): a parameter tree at real dims drawn on the device, for
whisper-bench -w 0 (cli/bench_model.py), with no file and no host copy.

The file has a synthetic vocabulary (the loader's `synthesize_missing`
fills the special tokens), a triangular mel filterbank, and random weights
drawn like tools/make_test_model.py `synth_tensors` (N(0, 1/fan_in) matrices,
0.02-scale biases, near-unit layer norms).  Optionally the `make_decisive`
rescaling of that tool boosts a small set of token rows so greedy argmax
margins stay far above rounding noise.  Every 2-D weight outside the
quantize skip-list is then block-quantized (as cli/quantize.py does) with
this package's numpy codecs.

Tensors are drawn one at a time from per-tensor seeds and written as they
come, so a full-width model (large-v3-turbo) needs little host memory.

    python -m whisper_tpu_torch.utils.synth --model large-v3-turbo \\
        --qtype q5_0 --seed 0 --out /tmp/turbo-q5_0.bin
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..formats import container, quants
from ..models.whisper import hparams as H
from ..models.whisper.hparams import WhisperHParams
from ..models.whisper.load import MelFilters, expected_tensor_names
from ..models.whisper.writer import QUANTIZE_SKIP, tensor_storage_type, write_header

MODELS = {"tiny": H.TINY, "base": H.BASE, "small": H.SMALL,
          "medium": H.MEDIUM, "large-v3": H.LARGE_V3,
          "large-v3-turbo": H.LARGE_V3_TURBO}
QTYPES = {"f16": (quants.GGML_FTYPE_MOSTLY_F16, None),
          "q4_0": (quants.GGML_FTYPE_MOSTLY_Q4_0, quants.GGML_TYPE_Q4_0),
          "q4_1": (quants.GGML_FTYPE_MOSTLY_Q4_1, quants.GGML_TYPE_Q4_1),
          "q5_0": (quants.GGML_FTYPE_MOSTLY_Q5_0, quants.GGML_TYPE_Q5_0),
          "q8_0": (quants.GGML_FTYPE_MOSTLY_Q8_0, quants.GGML_TYPE_Q8_0)}


def synth_vocab(hp: WhisperHParams):
    """Regular-token byte strings up to EOT: the 256 single bytes, then
    unique lowercase words (a base-26 spelling of the id after a space)."""
    n_read = 50256 + (1 if hp.n_vocab >= 51865 else 0)
    toks = [bytes([i]) for i in range(256)]
    for i in range(256, n_read):
        w, k = [], i
        while True:
            w.append(chr(ord("a") + k % 26))
            k //= 26
            if k == 0:
                break
        toks.append(b" " + "".join(w).encode())
    return toks


def synth_filters(n_mel: int, n_fft: int = 201, sample_rate: int = 16000) -> MelFilters:
    """Triangular filters evenly spaced on the mel scale (HTK formula)."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sample_rate / 2, n_fft)
    edges = hz(np.linspace(mel(0.0), mel(sample_rate / 2), n_mel + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rise = (freqs[None, :] - lo) / (mid - lo)
    fall = (hi - freqs[None, :]) / (hi - mid)
    fb = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return MelFilters(n_mel, n_fft, fb.astype(np.float32))


def _tensor(name: str, hp: WhisperHParams, rng: np.random.Generator) -> np.ndarray:
    """One weight of the checkpoint, drawn like make_test_model.synth_tensors."""
    ns, nm = hp.n_audio_state, hp.n_mels
    dec = name.startswith("decoder.")
    n = hp.n_text_state if dec else ns

    def w(*shape, std=None):
        std = std if std is not None else 1.0 / np.sqrt(shape[-1])
        return (rng.standard_normal(shape) * std).astype(np.float32)

    if name.endswith("ln.weight") or name.endswith("ln_post.weight") \
            or name.endswith("_ln.weight"):
        return (1.0 + 0.02 * rng.standard_normal(n)).astype(np.float32)
    if name.endswith("ln.bias") or name.endswith("ln_post.bias") \
            or name.endswith("_ln.bias"):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)
    fixed = {
        "encoder.positional_embedding": lambda: w(hp.n_audio_ctx, ns, std=0.02),
        "encoder.conv1.weight": lambda: w(ns, nm, 3),
        "encoder.conv1.bias": lambda: w(ns, 1, std=0.02),
        "encoder.conv2.weight": lambda: w(ns, ns, 3),
        "encoder.conv2.bias": lambda: w(ns, 1, std=0.02),
        "decoder.positional_embedding": lambda: w(hp.n_text_ctx, n, std=0.02),
        "decoder.token_embedding.weight": lambda: w(hp.n_vocab, n, std=0.02),
    }
    if name in fixed:
        return fixed[name]()
    if name.endswith("mlp.0.weight"):
        return w(4 * n, n)
    if name.endswith("mlp.0.bias"):
        return w(4 * n, std=0.02)
    if name.endswith("mlp.2.weight"):
        return w(n, 4 * n)
    if name.endswith(".weight"):
        return w(n, n)
    return w(n, std=0.02)


def make_decisive(tensors: Dict[str, np.ndarray], hp: WhisperHParams, seed: int,
                  n_text_active: int = 64, ts_stride: int = 25,
                  boost: float = 25.0, eot_boost: float = 1.15,
                  pos_mix: float = 3.0, ts_mix: float = 1.2) -> None:
    """tools/make_test_model.py make_decisive (steep_ts=0, no race, no tdrz):
    boost a small active set of token rows — N text tokens, every
    `ts_stride`-th timestamp and EOT — and mix one boosted row's direction
    into each decoder position, so the argmax races run between ~128
    well-separated candidates (gaps far above rounding noise) while the
    trajectory still varies with the audio."""
    W = tensors["decoder.token_embedding.weight"]
    n_vocab = W.shape[0]
    if n_vocab >= 51865:
        n_lang = n_vocab - 51765 - 1
        token_eot, token_sot = 50257, 50258
        token_beg = 50363 + 1 + (n_lang - 98)
        # script `-l auto` through position 0 (never sampled)
        lang_es = token_sot + 1 + 3
        W[lang_es] *= boost
        tensors["decoder.positional_embedding"][0] += 3.0 * W[lang_es]
    else:
        token_eot, token_beg = 50256, 50363
    rng = np.random.default_rng(seed + 7777)
    active = rng.choice(np.arange(1000, 50000), size=n_text_active, replace=False)
    ts_active = np.arange(token_beg, n_vocab, ts_stride)
    W[active] *= boost
    W[ts_active] *= boost
    W[token_eot] *= boost * eot_boost
    P = tensors["decoder.positional_embedding"]
    n_pos = P.shape[0]
    ts_choice = ts_active[np.clip(
        (np.arange(n_pos) * len(ts_active)) // n_pos
        + rng.integers(0, 3, n_pos), 0, len(ts_active) - 1)]
    pool = np.concatenate([
        rng.choice(active, size=n_pos),
        ts_choice,
        np.full(n_pos, token_eot),
    ]).reshape(3, -1)
    kind = rng.choice(3, size=n_pos, p=[0.80, 0.17, 0.03])
    script = pool[kind, np.arange(n_pos)]
    P += pos_mix * W[script] + ts_mix * W[ts_choice]


def write_synth_model(path: str, hp: WhisperHParams, seed: int = 0,
                      qtype: str = "q5_0", decisive: bool = False,
                      decisive_kw: Optional[dict] = None) -> None:
    """Write a complete model file at `hp` dims from `seed`."""
    ftype, ggml_q = QTYPES[qtype]
    names = expected_tensor_names(hp)

    def draw(name):
        return _tensor(name, hp, np.random.default_rng([seed, names.index(name)]))

    # the two tensors the decisive rescaling edits together
    special = {}
    if decisive:
        special = {n: draw(n) for n in ("decoder.token_embedding.weight",
                                        "decoder.positional_embedding")}
        make_decisive(special, hp, seed, **(decisive_kw or {}))
    with open(path, "wb") as f:
        write_header(f, hp, synth_filters(hp.n_mels), synth_vocab(hp), ftype)
        for name in names:
            arr = special.pop(name) if name in special else draw(name)
            if ggml_q is not None and arr.ndim == 2 and name not in QUANTIZE_SKIP:
                container.write_tensor_record(f, name, raw=quants.quantize(arr, ggml_q),
                                              ggml_type=ggml_q, shape=arr.shape)
            else:
                st = tensor_storage_type(name, arr.ndim, use_f16=True)
                container.write_tensor_record(f, name, arr, st)


def synth_params(hp: WhisperHParams, dtype=torch.bfloat16, seed: int = 0,
                 device="cpu"):
    """A whisper parameter tree with random weights at `hp` dims, drawn on
    `device` from `seed` (whisper_tpu/utils/synth.py synth_params): the
    layout of models/whisper/load.py, with the matmul weights in `dtype`
    and the rest in f32, as runtime/context.py installs a loaded file."""
    g = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, std=0.02, dt=torch.float32):
        return (torch.randn(shape, generator=g, device=device) * std).to(dt)

    def ones(*shape):
        return torch.ones(shape, device=device)

    ns, nm, L = hp.n_audio_state, hp.n_mels, hp.n_audio_layer
    nt, Lt, V = hp.n_text_state, hp.n_text_layer, hp.n_vocab

    def blocks(n, layers, cross):
        b = {
            "attn_ln_w": ones(layers, n), "attn_ln_b": w(layers, n),
            "qkv_w": w(layers, n, 3 * n, dt=dtype), "qkv_b": w(layers, 3 * n),
            "o_w": w(layers, n, n, dt=dtype), "o_b": w(layers, n),
            "mlp_ln_w": ones(layers, n), "mlp_ln_b": w(layers, n),
            "mlp0_w": w(layers, n, 4 * n, dt=dtype), "mlp0_b": w(layers, 4 * n),
            "mlp1_w": w(layers, 4 * n, n, dt=dtype), "mlp1_b": w(layers, n),
        }
        if cross:
            b.update({
                "xattn_ln_w": ones(layers, n), "xattn_ln_b": w(layers, n),
                "xq_w": w(layers, n, n, dt=dtype), "xq_b": w(layers, n),
                "xk_w": w(layers, n, n, dt=dtype),
                "xv_w": w(layers, n, n, dt=dtype), "xv_b": w(layers, n),
                "xo_w": w(layers, n, n, dt=dtype), "xo_b": w(layers, n),
            })
        return b

    return {
        "enc": {
            "pos_embd": w(hp.n_audio_ctx, ns),
            "conv1_w": w(ns, nm, 3, std=0.1, dt=dtype), "conv1_b": w(ns),
            "conv2_w": w(ns, ns, 3, std=0.1, dt=dtype), "conv2_b": w(ns),
            "ln_post_w": ones(ns), "ln_post_b": w(ns),
            "blocks": blocks(ns, L, cross=False),
        },
        "dec": {
            "pos_embd": w(hp.n_text_ctx, nt),
            "tok_embd": w(V, nt),
            "ln_w": ones(nt), "ln_b": w(nt),
            "blocks": blocks(nt, Lt, cross=True),
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="large-v3-turbo", choices=sorted(MODELS))
    ap.add_argument("--qtype", default="q5_0", choices=sorted(QTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decisive", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    write_synth_model(args.out, MODELS[args.model], args.seed, args.qtype,
                      args.decisive)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
