"""Plain Whisper in PyTorch: the reference the benchmark holds the port to.

Written from the published description (OpenAI's whisper/model.py and
whisper.cpp's src/whisper.cpp): the log-mel front end, the encoder (two
convolutions with GELU, pre-LN blocks, a final layer norm), and the
decoder as one full causal forward pass over a token sequence (no cache,
no batching, no kernel).  It reads the ggml file with the benchmark's own
reader (port_bench/ggml.py) and dequantizes every weight itself; it takes
nothing the program made and imports nothing of it.

`precision` "f32" is the reference: IEEE float32 products (TF32 off), the
mel in float64.  "fp8" is the control: every product's operands rounded to
float8 e4m3 with a per-tensor scale (an fp8 product with f32 accumulation,
the step below the port's bf16), and the mel's products in bfloat16.

Departures: GELU is the tanh form, as ggml's (whisper.cpp's graphs); the
key projections have no bias, as in the checkpoints.
"""

from __future__ import annotations

import contextlib
import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from .. import ggml

N_FFT, HOP, SAMPLE_RATE, CHUNK_S = 400, 160, 16000, 30
FP8_MAX = 448.0


@contextlib.contextmanager
def ieee_f32():
    cm = torch.backends.cuda.matmul
    saved = cm.allow_tf32, torch.backends.cudnn.allow_tf32
    cm.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cm.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer_norm(x, w, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


class Whisper:
    def __init__(self, model_bytes, device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision
        self.device = torch.device(device)
        mf = ggml.read_model(model_bytes)
        self.hp = mf.hp
        self.filters = mf.filters.astype(np.float64)
        self.vocab = mf.vocab
        W = lambda n: ggml.tensor_f32(mf, n, self.device)
        self.enc = {k: W(f"encoder.{k}") for k in (
            "positional_embedding", "conv1.weight", "conv1.bias", "conv2.weight",
            "conv2.bias", "ln_post.weight", "ln_post.bias")}
        self.dec = {k: W(f"decoder.{k}") for k in (
            "positional_embedding", "token_embedding.weight", "ln.weight", "ln.bias")}
        names = ggml.tensor_names(mf.hp)
        self.eblocks = [{n[len(f"encoder.blocks.{i}."):]: W(n) for n in names
                         if n.startswith(f"encoder.blocks.{i}.")}
                        for i in range(mf.hp["n_audio_layer"])]
        self.dblocks = [{n[len(f"decoder.blocks.{i}."):]: W(n) for n in names
                         if n.startswith(f"decoder.blocks.{i}.")}
                        for i in range(mf.hp["n_text_layer"])]

    # -- products ---------------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def linear(self, x, blk, name, bias=True):
        y = self.mm(x, blk[name + ".weight"].T)
        return y + blk[name + ".bias"] if bias else y

    # -- mel -----------------------------------------------------------------------

    def mel(self, pcm: np.ndarray):
        """(mel (n_mels, n_len) f32, n_len_org): whisper.cpp's
        log_mel_spectrogram: periodic Hann(400), hop 160, 200 samples
        reflected at the start, 30 s + 200 zeros at the end, power
        spectrum, filterbank, log10 with a 1e-10 floor, clamp to max - 8,
        (x + 4) / 4."""
        x = np.asarray(pcm, np.float64)
        n = len(x)
        n_reflect = min(N_FFT // 2, max(0, n - 1))
        head = np.concatenate([np.zeros(N_FFT // 2 - n_reflect), x[1:1 + n_reflect][::-1]])
        padded = np.concatenate([head, x, np.zeros(SAMPLE_RATE * CHUNK_S + N_FFT // 2)])
        n_len = (len(padded) - N_FFT) // HOP
        n_len_org = 1 + int((n + N_FFT // 2 - N_FFT) / HOP)
        i = np.arange(N_FFT)
        window = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / N_FFT))
        frames = padded[np.arange(n_len)[:, None] * HOP + i[None, :]] * window
        spec = np.fft.rfft(frames, n=N_FFT, axis=-1)
        power = spec.real ** 2 + spec.imag ** 2
        if self.precision == "fp8":
            p = torch.from_numpy(power).to(torch.bfloat16)
            f = torch.from_numpy(self.filters).to(torch.bfloat16)
            mel = (p @ f.T).double().numpy()
        else:
            mel = power @ self.filters.T
        mel = np.log10(np.maximum(mel, 1e-10))
        mel = np.maximum(mel, mel.max() - 8.0)
        return ((mel + 4.0) / 4.0).T.astype(np.float32), n_len_org

    # -- encoder ---------------------------------------------------------------------

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
        """x (C, T), w (O, C, 3), padding 1 -> (T_out, O), as one product."""
        cols = F.pad(x, (1, 1)).unfold(1, 3, stride)            # (C, T_out, 3)
        cols = cols.permute(1, 0, 2).reshape(cols.shape[1], -1)
        return self.mm(cols, w.reshape(w.shape[0], -1).T) + b.reshape(-1)

    def _attend(self, q, k, v, n_head: int, causal: bool):
        T, S = q.shape
        d = S // n_head
        qh, kh, vh = (t.reshape(-1, n_head, d).transpose(0, 1) for t in (q, k, v))
        s = self.mm(qh, kh.transpose(1, 2)) / math.sqrt(d)
        if causal:
            s = s + torch.full((T, kh.shape[1]), -math.inf, device=s.device).triu(1)
        o = self.mm(torch.softmax(s, -1), vh)
        return o.transpose(0, 1).reshape(T, S)

    def encode(self, mel_window: torch.Tensor) -> torch.Tensor:
        """mel (n_mels, 2 n_audio_ctx) on the device -> (n_audio_ctx, S)."""
        e, H = self.enc, self.hp["n_audio_head"]
        with ieee_f32():
            x = gelu(self._conv(mel_window.float(), e["conv1.weight"], e["conv1.bias"], 1))
            x = gelu(self._conv(x.T, e["conv2.weight"], e["conv2.bias"], 2))
            x = x + e["positional_embedding"][: x.shape[0]]
            for blk in self.eblocks:
                h = layer_norm(x, blk["attn_ln.weight"], blk["attn_ln.bias"])
                q = self.linear(h, blk, "attn.query")
                k = self.linear(h, blk, "attn.key", bias=False)
                v = self.linear(h, blk, "attn.value")
                x = x + self.linear(self._attend(q, k, v, H, False), blk, "attn.out")
                h = layer_norm(x, blk["mlp_ln.weight"], blk["mlp_ln.bias"])
                x = x + self.linear(gelu(self.linear(h, blk, "mlp.0")), blk, "mlp.2")
            return layer_norm(x, e["ln_post.weight"], e["ln_post.bias"])

    def cross_kv(self, enc_out: torch.Tensor) -> List[tuple]:
        with ieee_f32():
            return [(self.linear(enc_out, blk, "cross_attn.key", bias=False),
                     self.linear(enc_out, blk, "cross_attn.value")) for blk in self.dblocks]

    # -- decoder ---------------------------------------------------------------------

    def logits(self, tokens: List[int], kv: List[tuple]) -> torch.Tensor:
        """Raw logits (T, n_vocab) of one causal pass over `tokens` at
        positions 0..T-1, attending the window's cross K/V."""
        d, H = self.dec, self.hp["n_text_head"]
        tok = torch.as_tensor(tokens, device=self.device)
        with ieee_f32():
            x = d["token_embedding.weight"][tok] + d["positional_embedding"][: len(tokens)]
            for blk, (ck, cv) in zip(self.dblocks, kv):
                h = layer_norm(x, blk["attn_ln.weight"], blk["attn_ln.bias"])
                q = self.linear(h, blk, "attn.query")
                k = self.linear(h, blk, "attn.key", bias=False)
                v = self.linear(h, blk, "attn.value")
                x = x + self.linear(self._attend(q, k, v, H, True), blk, "attn.out")
                h = layer_norm(x, blk["cross_attn_ln.weight"], blk["cross_attn_ln.bias"])
                q = self.linear(h, blk, "cross_attn.query")
                x = x + self.linear(self._attend(q, ck, cv, H, False), blk, "cross_attn.out")
                h = layer_norm(x, blk["mlp_ln.weight"], blk["mlp_ln.bias"])
                x = x + self.linear(gelu(self.linear(h, blk, "mlp.0")), blk, "mlp.2")
            x = layer_norm(x, d["ln.weight"], d["ln.bias"])
            return self.mm(x, d["token_embedding.weight"].T)

    def token_text(self, tid: int) -> str:
        """A token's text as whisper.cpp prints it: its bytes, decoded alone."""
        return self.vocab[tid].decode("utf-8", "replace") if tid < len(self.vocab) else ""

    def window(self, mel: np.ndarray, seek: int) -> torch.Tensor:
        """The encoder's input at frame `seek`: 2 n_audio_ctx frames, zero
        past the end of the mel."""
        n = 2 * self.hp["n_audio_ctx"]
        w = np.zeros((mel.shape[0], n), np.float32)
        i1 = min(seek + n, mel.shape[1])
        if i1 > seek:
            w[:, : i1 - seek] = mel[:, seek:i1]
        return torch.from_numpy(w).to(self.device)

