"""Parakeet runtime context: pcm -> mel -> encode -> TDT decode -> segments.

Port of whisper_tpu/models/parakeet/context.py, which mirrors the reference
C API surface (include/parakeet.h): parakeet_full, parakeet_chunk
(streaming with persistent LSTM state), segment/token accessors, timings.

The context runs on the CUDA card unless the caller passes device="cpu";
with no card it raises.  It computes in f32, as the JAX context: every
device section holds decoding/graphs.py DEVICE_LOCK and full_f32, so
neither cuDNN's convolutions nor the matmuls take TF32.  Quantized files
keep their conformer weights packed (`model.PQW`) on the card and go dense
on the CPU (`use_packed_weights=None`), as the JAX package on and off its
accelerator; the mel is the torch device mel on the card and the numpy mel
on the CPU (`mel_backend="auto"`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from ...decoding.graphs import DEVICE_LOCK, full_f32
from ...runtime.context import resolve_device
from . import model as M
from .convert import params_from_numpy
from .decode import (ParakeetTokenData, TdtDecoder, max_out_for,
                     refine_timestamps_tdt, tdt_greedy_decode_batch,
                     unpack_token_data)
from .load import ParakeetModel, build_packed_overlay, load_parakeet_model
from .mel import log_mel_spectrogram, log_mel_spectrogram_torch
from .tokenizer import piece_to_text, tokenize


@dataclass
class ParakeetSegment:
    """parakeet_segment: t0/t1 in encoder-frame*subsampling ticks (10 ms)."""

    t0: int
    t1: int
    text: str
    tokens: List[ParakeetTokenData] = field(default_factory=list)


@dataclass
class FullParams:
    """parakeet_full_params (include/parakeet.h:239-278).

    strategy is always GREEDY (the only reference strategy); offset_ms /
    duration_ms are declared by the reference header but unused by its
    implementation (src/parakeet.cpp:3526-3548 defaults only) — kept here
    for struct-layout parity.  Callbacks:
      new_segment_callback(ctx, segment)
      new_token_callback(ctx, token_data)
      progress_callback(ctx, progress_int)
      encoder_begin_callback(ctx) -> bool   (False vetoes the run, rc -6)
      abort_callback() -> bool              (True aborts, rc -6/-7)
    """

    strategy: int = 0
    n_threads: int = 4
    offset_ms: int = 0
    duration_ms: int = 0
    no_context: bool = True
    audio_ctx: int = 0
    new_segment_callback: Any = None
    new_token_callback: Any = None
    progress_callback: Any = None
    encoder_begin_callback: Any = None
    abort_callback: Any = None


def _mel_bucket(n: int) -> int:
    """Power-of-two mel-time bucket (min 64) of the JAX context."""
    return max(64, 1 << (n - 1).bit_length())


class ParakeetContext:
    def __init__(self, model: ParakeetModel, device=None, dtype=torch.float32,
                 exact_shapes: bool = True, use_packed_weights=None,
                 mel_backend: str = "auto"):
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.model = model
        self.hp = model.hparams
        self.vocab = model.vocab
        self.dtype = dtype
        if mel_backend == "auto":
            mel_backend = "torch" if on_card else "numpy"
        if mel_backend not in ("numpy", "torch"):
            raise ValueError(f"unknown mel backend {mel_backend!r}")
        self.mel_backend = mel_backend
        # exact_shapes=True encodes the mel at its own length (the
        # reference's per-length graph); False pads mel time to the
        # power-of-two bucket that full_batch uses
        self.exact_shapes = exact_shapes
        self.mel: Optional[np.ndarray] = None
        self.n_len_org = 0
        self.result_all: List[ParakeetSegment] = []
        self.decoded_tokens: List[int] = []
        self.decoded_token_data: List[ParakeetTokenData] = []
        self.t_mel_us = self.t_encode_us = self.t_decode_us = 0
        # parakeet_get_logits support: when True, the decode loop also
        # stores one joint-logit row per emitted token (last full/chunk)
        self.capture_logits = False
        self.last_logits: Optional[np.ndarray] = None
        if use_packed_weights is None:
            use_packed_weights = on_card
        self.use_packed_weights = bool(use_packed_weights and model.qplanes)
        self.params = self.decoder = None
        if mel_backend == "torch":
            with DEVICE_LOCK:
                self._filters = torch.from_numpy(model.filters).to(self.device)
                self._window = torch.from_numpy(model.window).to(self.device)
        if model.is_empty:
            return
        tree = {k: dict(v) for k, v in model.params.items()}
        if self.use_packed_weights:
            # the packed planes take the dense leaves' place before upload
            for key, planes in build_packed_overlay(model.qplanes, self.hp).items():
                if key == "pre.out_w":
                    tree["pre"]["out_w"] = planes
                else:
                    tree["layers"][key] = planes
        with DEVICE_LOCK:
            self.params = params_from_numpy(tree, self.device, dtype)
        self.decoder = TdtDecoder(model, self.params, self.device, dtype)

    @staticmethod
    def from_file(path: str, **kw) -> "ParakeetContext":
        return ParakeetContext(load_parakeet_model(path), **kw)

    def fork_state(self) -> "ParakeetContext":
        """parakeet_init_state (include/parakeet.h:93): a decode state
        sharing the context's device weights and loop graphs — fresh mel /
        LSTM state / segments / timings, zero weight re-upload."""
        st = object.__new__(ParakeetContext)
        st.__dict__.update(self.__dict__)
        st.mel = None
        st.n_len_org = 0
        st.result_all = []
        st.decoded_tokens = []
        st.decoded_token_data = []
        st.t_mel_us = st.t_encode_us = st.t_decode_us = 0
        st.last_logits = None
        if self.decoder is not None:
            st.decoder = self.decoder.clone()
        return st

    # -- API surface ---------------------------------------------------------

    def _mel(self, samples: np.ndarray) -> np.ndarray:
        if self.mel_backend == "torch":
            with DEVICE_LOCK, full_f32():
                return log_mel_spectrogram_torch(samples, self._filters, self._window,
                                                 self.hp.n_fft).cpu().numpy()
        return log_mel_spectrogram(samples, self.model.filters, self.model.window,
                                   self.hp.n_fft)

    def pcm_to_mel(self, samples: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.mel = self._mel(samples)
        self.n_len_org = self.mel.shape[0]
        self.t_mel_us += int((time.perf_counter() - t0) * 1e6)

    def set_mel(self, mel: np.ndarray) -> None:
        self.mel = np.asarray(mel, np.float32)
        self.n_len_org = self.mel.shape[0]

    def reset_state(self) -> None:
        self.decoded_tokens.clear()
        self.decoded_token_data.clear()
        if self.decoder is not None:
            self.decoder.reset_state()

    def n_len(self) -> int:
        return 0 if self.mel is None else self.mel.shape[0]

    def tokenize(self, text: str) -> List[int]:
        return tokenize(self.vocab, text)

    def token_to_str(self, token_id: int) -> str:
        return self.vocab.id_to_token[token_id]

    def _encode(self, mel: np.ndarray, n_len_org) -> torch.Tensor:
        """mel (B, T, n_mels) numpy -> encoder frames (B, T', S) on the
        device, the time waited for included."""
        with DEVICE_LOCK, full_f32():
            m = torch.from_numpy(np.ascontiguousarray(mel, np.float32)).to(self.device)
            enc = M.encode(self.params, m, n_len_org, self.hp, self.dtype)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return enc

    def _padded_mel(self, offset: int = 0):
        mel = self.mel[offset:]
        if not self.exact_shapes:
            # same power-of-two bucketing as full_batch
            pad = _mel_bucket(mel.shape[0]) - mel.shape[0]
            if pad:
                mel = np.pad(mel, ((0, pad), (0, 0)))
        return mel

    # -- main entry points ----------------------------------------------------

    def full(self, samples: Optional[np.ndarray],
             params: Optional[FullParams] = None) -> int:
        """parakeet_full_with_state (src/parakeet.cpp:3570-3672)."""
        params = params or FullParams()
        self.result_all.clear()
        if params.no_context:
            self.reset_state()
        if params.progress_callback:
            params.progress_callback(self, 0)
        rc = self.chunk(samples, params)
        # the reference fires progress=100 only on its dynamic-graph long
        # path (mel > n_audio_ctx, src/parakeet.cpp:3628); same gate here
        if (rc == 0 and params.progress_callback
                and self.n_len_org > self.hp.n_audio_ctx):
            params.progress_callback(self, 100)
        return rc

    def encode_only(self, offset: int = 0) -> int:
        """parakeet_encode (include/parakeet.h:137): run the conformer on
        the stored mel from `offset`, caching the frames for inspection."""
        if self.mel is None or self.model.is_empty:
            return -1
        # valid length BEFORE padding (the stored n_len_org minus the
        # skipped prefix)
        n_len_org = min(max(self.n_len_org - offset, 0), self.mel[offset:].shape[0])
        self._cached_enc = self._encode(self._padded_mel(offset)[None], n_len_org)[0]
        return 0

    def chunk(self, samples: Optional[np.ndarray],
              params: Optional[FullParams] = None) -> int:
        """parakeet_chunk (src/parakeet.cpp:3683-3770): encode+decode the
        current mel, appending to the persistent decode state."""
        params = params or FullParams()
        if samples is not None and len(samples) > 0:
            self.pcm_to_mel(samples)
        if self.mel is None:
            return -1
        if self.model.is_empty:
            return 0  # header-only test model: full pipeline no-op

        # encoder_begin veto -> -6 (src/parakeet.cpp:3718-3723)
        if params.encoder_begin_callback is not None:
            if not params.encoder_begin_callback(self):
                return -6
        n_len_org = self.n_len_org

        t0 = time.perf_counter()
        enc = self._encode(self._padded_mel()[None], n_len_org)[0]
        self.t_encode_us += int((time.perf_counter() - t0) * 1e6)
        # the reference checks abort after each graph compute: encode fail
        # -> -6, decode fail -> -7 (src/parakeet.cpp:2099,2411,3724-3733)
        if params.abort_callback is not None and params.abort_callback():
            return -6

        n_frames = (n_len_org + self.hp.subsampling_factor - 1) \
            // self.hp.subsampling_factor
        n_frames = min(n_frames, enc.shape[0])

        t0 = time.perf_counter()
        new_tokens = self.decoder.decode(enc, n_frames,
                                         capture_logits=self.capture_logits)
        if self.capture_logits:
            self.last_logits = self.decoder.last_logits
        self.t_decode_us += int((time.perf_counter() - t0) * 1e6)
        if params.abort_callback is not None and params.abort_callback():
            return -7

        if params.new_token_callback:
            for td in new_tokens:
                params.new_token_callback(self, td)

        if new_tokens:
            first = not self.decoded_tokens
            text = ""
            for k, td in enumerate(new_tokens):
                text += piece_to_text(self.vocab.id_to_token[td.id],
                                      is_first_piece=(first and k == 0))
            self.decoded_tokens.extend(td.id for td in new_tokens)
            self.decoded_token_data.extend(new_tokens)
            refine_timestamps_tdt(self.vocab, new_tokens)
            if text:
                seg = ParakeetSegment(t0=0, t1=n_frames, text=text,
                                      tokens=new_tokens)
                self.result_all.append(seg)
                if params.new_segment_callback:
                    params.new_segment_callback(self, seg)
        return 0

    def full_batch(self, samples_list: List[np.ndarray],
                   params: Optional[FullParams] = None
                   ) -> List[List[ParakeetSegment]]:
        """Batched serving: transcribe independent utterances together.

        The mels are padded to one power-of-two time bucket (the conv stem
        sees the padding, as in the JAX package's vmapped encode), encoded
        as one batch with each row's key mask, and decoded by one TDT loop
        whose rows stop on their own.  Each utterance gets fresh LSTM state;
        results match sequential chunk() on the same padded mel.

        Returns one segment list per utterance; does NOT touch the
        context's persistent decode state.
        """
        if not samples_list:
            return []
        if self.model.is_empty:
            return [[] for _ in samples_list]
        hp = self.hp

        t0 = time.perf_counter()
        mels = [self._mel(s) for s in samples_list]
        self.t_mel_us += int((time.perf_counter() - t0) * 1e6)
        n_lens = np.array([m.shape[0] for m in mels], np.int64)
        bucket = _mel_bucket(int(n_lens.max()))
        mel_b = np.zeros((len(mels), bucket, hp.n_mels), np.float32)
        for i, m in enumerate(mels):
            mel_b[i, :m.shape[0]] = m

        t0 = time.perf_counter()
        enc_b = self._encode(mel_b, n_lens)
        self.t_encode_us += int((time.perf_counter() - t0) * 1e6)

        sub = hp.subsampling_factor
        n_frames = np.minimum((n_lens + sub - 1) // sub, enc_b.shape[1])
        max_out = max_out_for(int(n_frames.max()), hp)
        B = len(mels)
        D, L = hp.n_pred_dim, hp.n_pred_layers
        with DEVICE_LOCK:
            h0 = torch.zeros((B, L, D), dtype=self.dtype, device=self.device)
            c0 = torch.zeros_like(h0)

        t0 = time.perf_counter()
        tok, frame, didx, dval, p, plog, n_out, _, _ = tdt_greedy_decode_batch(
            self.decoder.loop, enc_b, [int(n) for n in n_frames], h0, c0, max_out)
        self.t_decode_us += int((time.perf_counter() - t0) * 1e6)

        results: List[List[ParakeetSegment]] = []
        for b in range(B):
            toks = unpack_token_data(self.vocab, sub, tok[b], frame[b],
                                     didx[b], dval[b], p[b], plog[b],
                                     int(n_out[b]))
            segs: List[ParakeetSegment] = []
            if toks:
                text = ""
                for k, td in enumerate(toks):
                    text += piece_to_text(self.vocab.id_to_token[td.id],
                                          is_first_piece=(k == 0))
                refine_timestamps_tdt(self.vocab, toks)
                if text:
                    segs.append(ParakeetSegment(t0=0, t1=int(n_frames[b]),
                                                text=text, tokens=toks))
            results.append(segs)
        return results

    # -- accessors (parakeet_full_* analogues) --------------------------------

    def n_segments(self) -> int:
        return len(self.result_all)

    def get_segment(self, i: int) -> ParakeetSegment:
        return self.result_all[i]

    def full_text(self) -> str:
        return "".join(s.text for s in self.result_all)

    def print_timings(self) -> str:
        loop = self.decoder.loop if self.decoder is not None else None
        lines = [
            f"parakeet:     mel time = {self.t_mel_us / 1000.0:8.2f} ms",
            f"parakeet:  encode time = {self.t_encode_us / 1000.0:8.2f} ms",
            f"parakeet:  decode time = {self.t_decode_us / 1000.0:8.2f} ms",
        ]
        if loop is not None:
            lines.append(f"parakeet:  decode loop = {loop.steps} steps, "
                         f"{loop.replays} replays, {loop.flag_reads} flag reads, "
                         f"{loop.graphs} graphs")
        return "\n".join(lines)
