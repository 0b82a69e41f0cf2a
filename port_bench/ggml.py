"""The legacy ggml Whisper container and the q5_0 block codec, frozen here.

Both the model file the benchmark writes and the plain reference's reader
use this module, never the program's own codecs, so a later change to the
program cannot move the yardstick.

Origins (copied, then cut to what the benchmark needs):
  * the header and tensor-record layout: whisper_tpu_torch/formats/container.py
    and whisper_tpu_torch/models/whisper/writer.py (`write_header`,
    `write_tensor_record`), whose reference is whisper.cpp's
    models/convert-pt-to-ggml.py:268-333 and src/whisper.cpp:1485-1962;
  * the tensor names in converter order: whisper_tpu_torch/models/whisper/load.py
    `expected_tensor_names`;
  * the synthetic vocabulary and mel filterbank: whisper_tpu_torch/utils/synth.py
    `synth_vocab`, `synth_filters`;
  * the q5_0 block: whisper_tpu_torch/formats/quants.py `dequantize_q5_0`
    (ggml-common.h:229-235): f16 d, u32 qh of fifth bits, 16 nibble bytes,
    value = (q - 16) * d, 32 values a block.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

MAGIC = 0x67676D6C
QNT_VERSION = 2
QNT_VERSION_FACTOR = 1000
TYPE_F32, TYPE_F16, TYPE_Q5_0 = 0, 1, 6
FTYPE_MOSTLY_Q5_0 = 8
QK = 32
Q5_0_BLOCK_BYTES = 22
# kept as stored in a quantized file (convert-pt-to-ggml.py:305-317)
F32_ALWAYS = ("encoder.conv1.bias", "encoder.conv2.bias",
              "encoder.positional_embedding", "decoder.positional_embedding")
HPARAM_KEYS = ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
               "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head",
               "n_text_layer", "n_mels")


def tensor_names(hp: Dict[str, int]) -> List[str]:
    """Every tensor of a whisper checkpoint, in converter order."""
    names = ["encoder.positional_embedding", "encoder.conv1.weight",
             "encoder.conv1.bias", "encoder.conv2.weight", "encoder.conv2.bias",
             "encoder.ln_post.weight", "encoder.ln_post.bias"]
    attn = ["attn_ln.weight", "attn_ln.bias", "attn.query.weight",
            "attn.query.bias", "attn.key.weight", "attn.value.weight",
            "attn.value.bias", "attn.out.weight", "attn.out.bias"]
    cross = ["cross_attn_ln.weight", "cross_attn_ln.bias",
             "cross_attn.query.weight", "cross_attn.query.bias",
             "cross_attn.key.weight", "cross_attn.value.weight",
             "cross_attn.value.bias", "cross_attn.out.weight",
             "cross_attn.out.bias"]
    mlp = ["mlp_ln.weight", "mlp_ln.bias", "mlp.0.weight", "mlp.0.bias",
           "mlp.2.weight", "mlp.2.bias"]
    for i in range(hp["n_audio_layer"]):
        names += [f"encoder.blocks.{i}.{n}" for n in attn + mlp]
    names += ["decoder.positional_embedding", "decoder.token_embedding.weight",
              "decoder.ln.weight", "decoder.ln.bias"]
    for i in range(hp["n_text_layer"]):
        names += [f"decoder.blocks.{i}.{n}" for n in attn + cross + mlp]
    return names


def tensor_shape(name: str, hp: Dict[str, int]) -> Tuple[int, ...]:
    """The numpy (row-major) shape of a checkpoint tensor."""
    dec = name.startswith("decoder.")
    n = hp["n_text_state"] if dec else hp["n_audio_state"]
    fixed = {
        "encoder.positional_embedding": (hp["n_audio_ctx"], n),
        "encoder.conv1.weight": (n, hp["n_mels"], 3),
        "encoder.conv1.bias": (n, 1),
        "encoder.conv2.weight": (n, n, 3),
        "encoder.conv2.bias": (n, 1),
        "decoder.positional_embedding": (hp["n_text_ctx"], n),
        "decoder.token_embedding.weight": (hp["n_vocab"], n),
    }
    if name in fixed:
        return fixed[name]
    if name.endswith("mlp.0.weight"):
        return (4 * n, n)
    if name.endswith("mlp.2.weight"):
        return (n, 4 * n)
    if name.endswith("mlp.0.bias"):
        return (4 * n,)
    if name.endswith(".weight") and not name.endswith("ln.weight") \
            and not name.endswith("ln_post.weight"):
        return (n, n)
    return (n,)


def storage_type(name: str, shape: Tuple[int, ...]) -> int:
    """q5_0 for every 2-D tensor but the skip list, f16 for the conv
    kernels, f32 for the rest (whisper-quantize on a converted file)."""
    if name in F32_ALWAYS or len(shape) < 2:
        return TYPE_F32
    if len(shape) == 2:
        return TYPE_Q5_0
    return TYPE_F16


def nbytes(ggml_type: int, n_elems: int) -> int:
    if ggml_type == TYPE_Q5_0:
        return n_elems // QK * Q5_0_BLOCK_BYTES
    return n_elems * (4 if ggml_type == TYPE_F32 else 2)


def synth_vocab(n_vocab: int) -> List[bytes]:
    """The 256 single bytes, then unique lowercase words up to EOT."""
    n_read = 50256 + (1 if n_vocab >= 51865 else 0)
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


def synth_filters(n_mel: int, n_fft: int = 201, sample_rate: int = 16000) -> np.ndarray:
    """Triangular filters evenly spaced on the mel scale, (n_mel, n_fft)."""
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
    return fb.astype(np.float32)


def header_bytes(hp: Dict[str, int], filters: np.ndarray, vocab: List[bytes]) -> bytes:
    out = [struct.pack("<I", MAGIC)]
    out += [struct.pack("<i", int(hp[k])) for k in HPARAM_KEYS]
    out.append(struct.pack("<i", FTYPE_MOSTLY_Q5_0 + QNT_VERSION * QNT_VERSION_FACTOR))
    out.append(struct.pack("<ii", *filters.shape))
    out.append(np.ascontiguousarray(filters, dtype="<f4").tobytes())
    out.append(struct.pack("<i", len(vocab)))
    for t in vocab:
        out.append(struct.pack("<i", len(t)) + t)
    return b"".join(out)


def record_header(name: str, ggml_type: int, shape: Tuple[int, ...]) -> bytes:
    ne = list(reversed([int(s) for s in shape]))
    nb = name.encode("utf-8")
    return struct.pack("<iii", len(ne), len(nb), ggml_type) + \
        struct.pack(f"<{len(ne)}i", *ne) + nb


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

@dataclass
class ModelFile:
    hp: Dict[str, int]
    filters: np.ndarray                  # (n_mel, n_fft) f32
    vocab: List[bytes]                   # the tokens the file holds
    tensors: Dict[str, Tuple[int, Tuple[int, ...], memoryview]]  # type, shape, raw


def read_model(buf) -> ModelFile:
    """Parse a whole model file held in memory (bytes, mmap or memoryview)."""
    mv = memoryview(buf)
    pos = 0

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(mv):
            raise EOFError("truncated model file")
        out = mv[pos:pos + n]
        pos += n
        return out

    def i32() -> int:
        return struct.unpack("<i", take(4))[0]

    if struct.unpack("<I", take(4))[0] != MAGIC:
        raise ValueError("not a ggml model file")
    hp = {k: i32() for k in HPARAM_KEYS}
    hp["ftype"] = i32() % QNT_VERSION_FACTOR
    n_mel, n_fft = i32(), i32()
    filters = np.frombuffer(take(4 * n_mel * n_fft), dtype="<f4").reshape(n_mel, n_fft)
    vocab = []
    for _ in range(i32()):
        vocab.append(bytes(take(i32())))
    tensors = {}
    while pos < len(mv):
        n_dims, name_len, ggml_type = (i32() for _ in range(3))
        ne = [i32() for _ in range(n_dims)]
        name = bytes(take(name_len)).decode("utf-8")
        shape = tuple(reversed(ne))
        tensors[name] = (ggml_type, shape, take(nbytes(ggml_type, int(np.prod(ne)))))
    return ModelFile(hp, filters.astype(np.float32), vocab, tensors)


def q5_0_to_f32(raw: torch.Tensor) -> torch.Tensor:
    """Blocks (nb, 22) uint8 on any device -> (nb * 32,) f32 values."""
    raw = raw.reshape(-1, Q5_0_BLOCK_BYTES)
    d = raw[:, 0:2].contiguous().view(torch.float16).float()        # (nb, 1)
    qh = raw[:, 2:6].to(torch.int64)
    qh = qh[:, 0] | (qh[:, 1] << 8) | (qh[:, 2] << 16) | (qh[:, 3] << 24)
    qs = raw[:, 6:].to(torch.int64)                                  # (nb, 16)
    bit = torch.arange(16, device=raw.device)
    h0 = ((qh[:, None] >> bit) & 1) << 4
    h1 = ((qh[:, None] >> (bit + 16)) & 1) << 4
    lo = ((qs & 0x0F) | h0) - 16
    hi = ((qs >> 4) | h1) - 16
    return (torch.cat([lo, hi], 1).float() * d).reshape(-1)


def tensor_f32(mf: ModelFile, name: str, device) -> torch.Tensor:
    """A tensor of the file as f32 on `device`, in its numpy shape."""
    ggml_type, shape, raw = mf.tensors[name]
    if ggml_type == TYPE_F32:
        t = torch.frombuffer(bytearray(raw), dtype=torch.float32)
    elif ggml_type == TYPE_F16:
        t = torch.frombuffer(bytearray(raw), dtype=torch.float16)
    elif ggml_type == TYPE_Q5_0:
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    else:
        raise ValueError(f"{name}: ggml type {ggml_type} is not one the benchmark writes")
    t = t.to(device)
    if ggml_type == TYPE_Q5_0:
        t = q5_0_to_f32(t)
    return t.float().reshape(shape)
