"""Silero-VAD v5/v6 runtime: model loader, PyTorch forward, segment extraction.

Port of whisper_tpu/models/vad/silero.py.  Reference behavior:
src/whisper.cpp:4365-4634 (model structs + graph), :4786-5000 (loader),
:5120-5210 (per-chunk detection loop), :5227-5461 (prob -> segment state
machine).  Model file = legacy ggml container with a VAD-specific header
(models/convert-silero-vad-to-ggml.py:32-77).

As in the JAX package, the STFT + conv encoder runs for ALL chunks in one
batched pass and only the order-dependent 128-d LSTM + final projection
runs as a scan over the chunk axis, the input gates hoisted out of it.  On
the CUDA card the whole forward of a chunk bucket (a power of two, at least
8) is one captured CUDA graph (decoding/graphs.py CountedGraph), the JAX
package's one jit per bucket: a call copies its chunks in, replays, and
reads the probabilities back once.  On the CPU it runs eagerly.  Either
way it computes in IEEE f32, whatever the caller's TF32 flags
(decoding/graphs.py full_f32): a TF32 STFT moves probabilities near the
threshold and flips segments.

The loader, the tensor names and the prob -> segment state machine are
framework-free copies of the JAX module's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...decoding.graphs import DEVICE_LOCK, CountedGraph, full_f32
from ...formats import container

SAMPLE_RATE = 16000

# tensor names in the model file (reference: src/whisper-arch.h:181-197)
STFT_BASIS = "_model.stft.forward_basis_buffer"
ENC_W = ["_model.encoder.%d.reparam_conv.weight" % i for i in range(4)]
ENC_B = ["_model.encoder.%d.reparam_conv.bias" % i for i in range(4)]
LSTM_W_IH = "_model.decoder.rnn.weight_ih"
LSTM_W_HH = "_model.decoder.rnn.weight_hh"
LSTM_B_IH = "_model.decoder.rnn.bias_ih"
LSTM_B_HH = "_model.decoder.rnn.bias_hh"
FINAL_W = "_model.decoder.decoder.2.weight"
FINAL_B = "_model.decoder.decoder.2.bias"


@dataclass
class VadHParams:
    """src/whisper.cpp:4368-4377."""

    n_encoder_layers: int = 4
    encoder_in_channels: Tuple[int, ...] = (129, 128, 64, 64)
    encoder_out_channels: Tuple[int, ...] = (128, 64, 64, 128)
    kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    lstm_input_size: int = 128
    lstm_hidden_size: int = 128
    final_conv_in: int = 128
    final_conv_out: int = 1


# conv strides of the 4 encoder layers (src/whisper.cpp:4568-4589)
ENC_STRIDES = (1, 2, 2, 1)


@dataclass
class VadModel:
    model_type: str
    version: str
    n_window: int  # 512
    n_context: int  # 64 (reflect-pad amount per side is fixed at 64)
    hparams: VadHParams
    tensors: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def is_empty(self) -> bool:
        return not self.tensors


def _read_string(f: BinaryIO) -> str:
    n = container.read_i32(f)
    return f.read(n).decode("utf-8")


def load_vad_model(path: str) -> VadModel:
    """Read a silero-vad ggml file (src/whisper.cpp:4786-5110).  A file with
    zero tensor records loads as an 'empty model for testing' like the
    reference (:5103)."""
    with open(path, "rb") as f:
        container.check_magic(f)
        model_type = _read_string(f)
        major, minor, patch = (container.read_i32(f) for _ in range(3))
        n_window = container.read_i32(f)
        n_context = container.read_i32(f)

        n_layers = container.read_i32(f)
        in_ch, out_ch, ks = [], [], []
        for _ in range(n_layers):
            in_ch.append(container.read_i32(f))
            out_ch.append(container.read_i32(f))
            ks.append(container.read_i32(f))
        hp = VadHParams(
            n_encoder_layers=n_layers,
            encoder_in_channels=tuple(in_ch),
            encoder_out_channels=tuple(out_ch),
            kernel_sizes=tuple(ks),
            lstm_input_size=container.read_i32(f),
            lstm_hidden_size=container.read_i32(f),
            final_conv_in=container.read_i32(f),
            final_conv_out=container.read_i32(f),
        )
        tensors = {r.name: r.to_f32() for r in container.read_tensor_records(f)}
    return VadModel(model_type, f"{major}.{minor}.{patch}", n_window,
                    n_context, hp, tensors)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _forward_probs(params: Dict[str, torch.Tensor], chunks: torch.Tensor,
                   h0: torch.Tensor, c0: torch.Tensor):
    """All-chunk speech probabilities (whisper_tpu/models/vad/silero.py
    `_forward_probs`, the same ops in the same order).

    chunks: [n_chunks, n_window] f32.  Returns (probs [n_chunks], h, c).
    Mirrors whisper_vad_build_graph (src/whisper.cpp:4543-4680): per-chunk
    reflect pad 64 | STFT-as-conv stride 128 | magnitude | 4x conv-relu |
    take frame 0 | LSTM cell | relu | 1x1 conv | sigmoid.  The caller
    holds full_f32.
    """
    n = chunks.shape[0]
    # reflect-pad each chunk independently (ggml_pad_reflect_1d(cur,64,64))
    x = F.pad(chunks[:, None, :], (64, 64), mode="reflect")  # [n, 1, 640]

    # STFT as conv: basis (258, 1, 256), stride 128 -> [n, 258, 4]
    stft = F.conv1d(x, params["stft"], stride=128)
    cutoff = stft.shape[1] // 2
    mag = torch.sqrt(stft[:, :cutoff, :] ** 2 + stft[:, cutoff:, :] ** 2)

    cur = mag
    for i, stride in enumerate(ENC_STRIDES):
        cur = F.conv1d(cur, params[f"enc{i}_w"], stride=stride, padding=1)
        cur = cur + params[f"enc{i}_b"][None, :, None]
        cur = torch.relu(cur)
    feats = cur[:, :, 0]  # [n, 128] — pytorch's [:, :, 0]

    w_ih, b_ih = params["lstm_w_ih"], params["lstm_b_ih"]
    w_hh, b_hh = params["lstm_w_hh"], params["lstm_b_hh"]
    hdim = w_hh.shape[1]

    # hoist the input-to-hidden matmul out of the scan (one batched product)
    x_gates = feats @ w_ih.T + b_ih  # [n, 4*hdim]

    # the scan: each step writes its h into a row of hs, which the next
    # step reads (eight launches a step; the graph replays them)
    hs = torch.empty((n, hdim), dtype=chunks.dtype, device=chunks.device)
    h, c = h0, c0
    for t in range(n):
        gates = torch.addmv(x_gates[t], w_hh, h) + b_hh
        sig = torch.sigmoid(gates)             # i, f, o (g's slot unused)
        g_t = torch.tanh(gates[2 * hdim:3 * hdim])
        c = torch.addcmul(sig[hdim:2 * hdim] * c, sig[:hdim], g_t)
        h = torch.mul(sig[3 * hdim:], torch.tanh(c), out=hs[t])
    out = torch.relu(hs)  # [n, hdim]
    logit = out @ params["final_w"].T + params["final_b"]  # [n, 1]
    return torch.sigmoid(logit[:, 0]), h, c


class _BucketGraph:
    """The forward of one chunk bucket captured as a CUDA graph: static
    chunk, h0 and c0 buffers in, the graph's probs, h and c out."""

    def __init__(self, params, bucket: int, n_window: int, hdim: int, device):
        self.chunks = torch.zeros((bucket, n_window), device=device)
        self.h0 = torch.zeros(hdim, device=device)
        self.c0 = torch.zeros(hdim, device=device)
        self.out = None

        def run():
            self.out = _forward_probs(params, self.chunks, self.h0, self.c0)

        self.graph = CountedGraph(run, torch.cuda.graph_pool_handle())


class VadContext:
    """whisper_vad_context analogue: holds the model on `device` (the CUDA
    card unless the caller passes "cpu"), the forward's CUDA graph per
    chunk bucket, and the persistent LSTM h/c state
    (whisper_vad_reset_state, src/whisper.cpp:5115)."""

    def __init__(self, model: VadModel, device=None):
        from ...runtime.context import resolve_device

        self.model = model
        self.device = resolve_device(device)
        hdim = model.hparams.lstm_hidden_size
        self._h = torch.zeros(hdim, device=self.device)
        self._c = torch.zeros(hdim, device=self.device)
        self.probs: Optional[np.ndarray] = None
        self.t_vad_us = 0
        self._graphs: Dict[int, _BucketGraph] = {}
        self.params = None
        if not model.is_empty:
            t = model.tensors
            host = {
                "stft": t[STFT_BASIS],
                "lstm_w_ih": t[LSTM_W_IH],
                "lstm_b_ih": t[LSTM_B_IH],
                "lstm_w_hh": t[LSTM_W_HH],
                "lstm_b_hh": t[LSTM_B_HH],
                "final_w": t[FINAL_W].reshape(1, -1),
                "final_b": t[FINAL_B],
            }
            for i in range(4):
                host[f"enc{i}_w"] = t[ENC_W[i]]
                host[f"enc{i}_b"] = t[ENC_B[i]]
            with DEVICE_LOCK:
                self.params = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)
                                                   ).to(self.device)
                               for k, v in host.items()}

    @staticmethod
    def from_file(path: str, **kw) -> "VadContext":
        return VadContext(load_vad_model(path), **kw)

    def reset_state(self) -> None:
        """whisper_vad_reset_state: zero the LSTM h/c."""
        with DEVICE_LOCK:
            self._h = torch.zeros_like(self._h)
            self._c = torch.zeros_like(self._c)

    def _run(self, chunks: np.ndarray) -> torch.Tensor:
        """The forward over (bucket, n_window) chunks from the current h/c:
        the bucket's graph on the card (captured at its first use), eager on
        the CPU.  Updates h/c; returns the probs on the device."""
        if self.device.type != "cuda":
            with full_f32():
                probs, self._h, self._c = _forward_probs(
                    self.params, torch.from_numpy(chunks), self._h, self._c)
            return probs
        bucket = chunks.shape[0]
        g = self._graphs.get(bucket)
        if g is None:
            with full_f32():
                g = self._graphs[bucket] = _BucketGraph(
                    self.params, bucket, self.model.n_window, self._h.shape[0],
                    self.device)
        g.chunks.copy_(torch.from_numpy(chunks))
        g.h0.copy_(self._h)
        g.c0.copy_(self._c)
        g.graph.replay()
        probs, h, c = g.out
        self._h, self._c = h.clone(), c.clone()
        return probs

    def detect_speech(self, samples: np.ndarray,
                      reset: bool = True) -> np.ndarray:
        """whisper_vad_detect_speech (src/whisper.cpp:5120-5210): chunk into
        n_window windows (zero-pad the tail) and compute one speech prob per
        chunk.  Chunk count is padded to a power-of-two bucket, so a process
        captures O(log n) graphs; h/c come back from the padded scan, as in
        the JAX package."""
        if reset:
            self.reset_state()
        nw = self.model.n_window
        n = len(samples)
        n_chunks = (n + nw - 1) // nw
        if self.model.is_empty:
            # empty test model: pretend everything is speech (prob 1)
            self.probs = np.ones(n_chunks, np.float32)
            return self.probs

        t0 = time.perf_counter()
        bucket = max(8, 1 << (n_chunks - 1).bit_length())
        buf = np.zeros(bucket * nw, np.float32)
        buf[:n] = samples
        with DEVICE_LOCK:
            probs = self._run(buf.reshape(bucket, nw))
            self.probs = probs[:n_chunks].cpu().numpy()
        self.t_vad_us += int((time.perf_counter() - t0) * 1e6)
        return self.probs


# --------------------------------------------------------------------------
# prob -> segment state machine (exact port: src/whisper.cpp:5227-5461)
# --------------------------------------------------------------------------

@dataclass
class VadSegment:
    start: int  # centiseconds
    end: int


def _samples_to_cs(samples: int) -> int:
    return int(samples / SAMPLE_RATE * 100.0 + 0.5)


def cs_to_samples(cs: int) -> int:
    return int(cs / 100.0 * SAMPLE_RATE + 0.5)


def segments_from_probs(probs: np.ndarray, vad_params,
                        n_window: int = 512) -> List[VadSegment]:
    p = vad_params
    n_probs = len(probs)
    sr = SAMPLE_RATE
    min_silence_samples = sr * p.min_silence_duration_ms // 1000
    audio_length_samples = n_probs * n_window
    min_speech_samples = sr * p.min_speech_duration_ms // 1000
    speech_pad_samples = sr * p.speech_pad_ms // 1000
    INT_MAX = 2**31 - 1
    if p.max_speech_duration_s > 100000.0:
        max_speech_samples = INT_MAX // 2
    else:
        tmp = sr * int(p.max_speech_duration_s) - n_window - 2 * speech_pad_samples
        max_speech_samples = INT_MAX // 2 if (tmp > INT_MAX or tmp < 0) else tmp
    min_silence_samples_at_max_speech = sr * 98 // 1000
    neg_threshold = max(p.threshold - 0.15, 0.01)

    speeches: List[List[int]] = []
    is_speech = False
    temp_end = prev_end = next_start = curr_start = 0
    has_curr = False

    for i in range(n_probs):
        prob = float(probs[i])
        cur = n_window * i

        if prob >= p.threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = cur

        if prob >= p.threshold and not is_speech:
            is_speech = True
            curr_start = cur
            has_curr = True
            continue

        if is_speech and (cur - curr_start) > max_speech_samples:
            if prev_end:
                speeches.append([curr_start, prev_end])
                has_curr = True
                if next_start < prev_end:
                    is_speech = False
                    has_curr = False
                else:
                    curr_start = next_start
                prev_end = next_start = temp_end = 0
            else:
                speeches.append([curr_start, cur])
                prev_end = next_start = temp_end = 0
                is_speech = False
                has_curr = False
                continue

        if prob < neg_threshold and is_speech:
            if not temp_end:
                temp_end = cur
            if (cur - temp_end) > min_silence_samples_at_max_speech:
                prev_end = temp_end
            if (cur - temp_end) < min_silence_samples:
                continue
            else:
                if (temp_end - curr_start) > min_speech_samples:
                    speeches.append([curr_start, temp_end])
                prev_end = next_start = temp_end = 0
                is_speech = False
                has_curr = False
                continue

    if has_curr and (audio_length_samples - curr_start) > min_speech_samples:
        speeches.append([curr_start, audio_length_samples])

    # merge adjacent segments with gap < 200 ms (:5366-5390)
    max_merge_gap = sr * 200 // 1000
    i = 0
    while i < len(speeches) - 1:
        if speeches[i + 1][0] - speeches[i][1] < max_merge_gap:
            speeches[i][1] = speeches[i + 1][1]
            del speeches[i + 1]
        else:
            i += 1

    # drop anything still under min duration (:5393-5402)
    speeches = [s for s in speeches if s[1] - s[0] >= min_speech_samples]

    # apply padding (:5415-5450)
    for i in range(len(speeches)):
        if i == 0:
            speeches[i][0] = max(0, speeches[i][0] - speech_pad_samples)
        if i < len(speeches) - 1:
            gap = speeches[i + 1][0] - speeches[i][1]
            if gap < 2 * speech_pad_samples:
                speeches[i][1] += gap // 2
                speeches[i + 1][0] = max(0, speeches[i + 1][0] - gap // 2)
            else:
                speeches[i][1] = min(speeches[i][1] + speech_pad_samples,
                                     audio_length_samples)
                speeches[i + 1][0] = max(0, speeches[i + 1][0] - speech_pad_samples)
        else:
            speeches[i][1] = min(speeches[i][1] + speech_pad_samples,
                                 audio_length_samples)

    return [VadSegment(_samples_to_cs(s), _samples_to_cs(e))
            for s, e in speeches]


def segments_from_samples(vctx: VadContext, vad_params,
                          samples: np.ndarray) -> List[VadSegment]:
    """whisper_vad_segments_from_samples (src/whisper.cpp:5463-5475)."""
    probs = vctx.detect_speech(samples)
    return segments_from_probs(probs, vad_params, vctx.model.n_window)
