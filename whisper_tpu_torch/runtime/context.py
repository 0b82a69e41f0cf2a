"""WhisperContext — device weights, the mel, encoder outputs, the KV cache
and phase timers (whisper_context + whisper_state, src/whisper.cpp:824-900).

Port of whisper_tpu/runtime/context.py.  The context runs on the CUDA card
unless the caller passes device="cpu"; with no card it raises instead of
carrying on on the CPU.  The compute type is bf16 on the card (as on the
TPU) and f32 on the CPU (as the JAX package off the TPU).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import LogMel
from ..decoding import device_loop as DL
from ..decoding.logits import LogitFilterTables
from ..models.whisper import model as M
from ..models.whisper.convert import params_from_numpy
from ..models.whisper.load import WhisperModel, build_qweight_overlay, load_model
from ..ops.qmm import QWeight, QWeightT
from .timings import Timings

# token-count buckets for prompt decodes (steps are always 1)
TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 448)

# dense matmul weights: stored in the compute type on the device, since
# every product rounds its operands to it anyway (saves memory and a cast
# per call; biases, norms and embeddings stay f32)
_MATMUL_KEYS = {"qkv_w", "o_w", "mlp0_w", "mlp1_w", "xq_w", "xk_w", "xv_w",
                "xo_w", "conv1_w", "conv2_w"}


def _bucket(n: int) -> int:
    for b in TOKEN_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"too many tokens: {n}")


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the CUDA card; raises when no card is there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "whisper_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _cast_matmul_weights(tree, dtype):
    if isinstance(tree, dict):
        return {k: (v.to(dtype) if k in _MATMUL_KEYS and torch.is_tensor(v)
                    else _cast_matmul_weights(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_matmul_weights(v, dtype) for v in tree]
    return tree


class WhisperContext:
    def __init__(self, model: WhisperModel, device=None, compute_dtype=None,
                 use_packed_weights=None, kv_itype: str = "f16",
                 cross_itype: str = "f16", precision: Optional[str] = None):
        if precision == "ggml_cpu_f16":
            raise NotImplementedError(
                "precision='ggml_cpu_f16' (ggml-CPU parity mode) is not ported")
        if precision not in (None, "default"):
            raise ValueError(f"unknown precision mode {precision!r}")
        if kv_itype not in ("f16", "q8") or cross_itype not in ("f16", "q8"):
            raise ValueError(f"kv_itype/cross_itype must be 'f16' or 'q8', got "
                             f"{kv_itype!r}/{cross_itype!r}")
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.model = model
        self.hp = model.hparams
        self.vocab = model.vocab
        self.is_empty = model.is_empty
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if on_card else torch.float32)
        self.cache_dtype = torch.float32
        self.kv_itype = kv_itype
        self.cross_itype = cross_itype
        self.params = (None if model.is_empty
                       else params_from_numpy(model.params, self.device))

        # packed path for quantized files: the decoder's hot matmuls and the
        # logits head stay block-quantized on the device as TRANSPOSED,
        # PER-LAYER planes for the streaming kernel (ops/qmm.py); the dense
        # leaves they replace are dropped.  Default on for the card, off on
        # the CPU (dense f32 there, as the JAX package off the TPU).
        if use_packed_weights is None:
            use_packed_weights = on_card
        self.use_packed_weights = bool(use_packed_weights and model.qparams)
        if self.use_packed_weights:
            self._install_packed(build_qweight_overlay(model.qparams, self.hp))
        if self.params is not None and self.compute_dtype != torch.float32:
            self.params = _cast_matmul_weights(self.params, self.compute_dtype)

        self.mel_fn = LogMel(model.filters.data)
        self.timings = Timings()
        self.filter_tables: Optional[LogitFilterTables] = None  # set per window
        self.mel: Optional[np.ndarray] = None       # (n_mel, n_len)
        self.n_len_org: int = 0
        self.lang_id: int = 0
        self.no_speech_prob: float = 0.0
        self.xk = None
        self.xv = None
        self._window_fns: Dict[Tuple, object] = {}
        # lockstep window batcher of the JAX package (runtime/batching.py):
        # not ported; a context with one attached refuses to decode
        self.batcher = None

    def enable_dtw(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "DTW token timestamps are not ported to whisper_tpu_torch")

    def _install_packed(self, overlay) -> None:
        dev = self.device

        def t(a, dt):
            return (None if a is None else
                    torch.from_numpy(np.ascontiguousarray(a.T)).to(dev, dt))

        n_layers = self.hp.n_text_layer
        blocks_packed = [dict() for _ in range(n_layers)]
        for key, (codes, scales, mins) in overlay["blocks"].items():
            for l in range(n_layers):
                blocks_packed[l][key] = QWeightT(
                    t(codes[l], torch.int8), t(scales[l], torch.float32),
                    t(None if mins is None else mins[l], torch.float32))
            del self.params["dec"]["blocks"][key]
        if any(blocks_packed[0]):
            self.params["dec"]["blocks_packed"] = blocks_packed
        if "tok_embd" in overlay:
            codes, scales, mins = overlay["tok_embd"]

            def d(a, dt):
                return None if a is None else torch.from_numpy(
                    np.ascontiguousarray(a)).to(dev, dt)

            self.params["dec"]["tok_embd"] = QWeight(
                d(codes, torch.int8), d(scales, torch.float32),
                d(mins, torch.float32))
            # transposed copy for the logits head's streaming kernel
            self.params["dec"]["tok_embd_t"] = QWeightT(
                t(codes, torch.int8), t(scales, torch.float32),
                t(mins, torch.float32))

    @staticmethod
    def from_file(path: str, **kw) -> "WhisperContext":
        return WhisperContext(load_model(path), **kw)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- mel -----------------------------------------------------------------

    def pcm_to_mel(self, samples: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.mel, self.n_len_org = self.mel_fn(samples)
        self.timings.t_mel_us += int((time.perf_counter() - t0) * 1e6)

    @property
    def n_len(self) -> int:
        return 0 if self.mel is None else self.mel.shape[1]

    # -- public compute ---------------------------------------------------------

    def encode_window(self, seek: int, audio_ctx: int = 0) -> None:
        """Encode 2*n_ctx mel frames starting at `seek`
        (whisper_encode_internal, src/whisper.cpp:2364-2462)."""
        assert self.mel is not None, "call pcm_to_mel first"
        hp = self.hp
        n_ctx = audio_ctx if audio_ctx > 0 else hp.n_audio_ctx
        t0 = time.perf_counter()
        window = np.zeros((hp.n_mels, 2 * n_ctx), np.float32)
        i1 = min(seek + 2 * n_ctx, self.n_len)
        if i1 > seek:
            window[:, : i1 - seek] = self.mel[:, seek:i1]
        enc = M.encode(self.params, torch.from_numpy(window).to(self.device),
                       hp, dtype=self.compute_dtype)
        self.xk, self.xv = M.compute_cross_kv(
            self.params, enc, hp, dtype=self.compute_dtype,
            itype=self.cross_itype)
        self._sync()
        self.timings.t_encode_us += int((time.perf_counter() - t0) * 1e6)
        self.timings.n_encode += 1
        # max_initial_ts precision derives from the MODEL's full audio ctx
        # (src/whisper.cpp:6338)
        self.filter_tables = LogitFilterTables(self.vocab, hp.n_audio_ctx)

    def new_cache(self, n_beam: int, dtype=None):
        return M.new_cache(self.hp, n_beam, dtype or self.cache_dtype,
                           itype=self.kv_itype, device=self.device)

    def decode_window_device(self, prompt, n_beams: int, temperature: float,
                             seek: int, seek_end: int, params,
                             no_timestamps: bool, rng_seed: int,
                             strategy: str = "greedy") -> DL.WindowResult:
        """Decode a whole window with the token-loop state on the device
        (decoding/device_loop.py), with the window strategy "greedy" or
        "beam"; returns a WindowResult of numpy arrays."""
        if self.batcher is not None:
            raise NotImplementedError(
                "the window batcher is not ported to whisper_tpu_torch")
        bt = _bucket(len(prompt))
        key = (n_beams, bt, no_timestamps, params.single_segment, strategy)
        fn = self._window_fns.get(key)
        if fn is None:
            fn = self._window_fns[key] = DL.make_window_decoder(
                self.hp, n_beams, bt, self.compute_dtype, no_timestamps,
                params.single_segment, self.vocab.token_eot,
                self.vocab.token_beg, kv_itype=self.kv_itype, strategy=strategy)
        base_mask, initial_mask = DL.build_masks(self.filter_tables, params)
        prompt_padded = np.zeros(bt, np.int64)
        prompt_padded[: len(prompt)] = prompt
        dev = self.device
        t0 = time.perf_counter()
        res = fn(self.params, torch.from_numpy(prompt_padded).to(dev),
                 len(prompt), self.xk, self.xv,
                 torch.from_numpy(base_mask).to(dev),
                 torch.from_numpy(initial_mask).to(dev), float(temperature),
                 int(seek), int(seek_end), int(params.max_tokens), rng_seed)
        self.timings.t_decode_us += int((time.perf_counter() - t0) * 1e6)
        self.timings.n_decode += int(res.n_tok.max()) if res.n_tok.size else 0
        self.timings.n_prompt += len(prompt)
        return res

    def clone_state(self) -> "WhisperContext":
        """A shallow clone sharing weights but with its own per-stream state
        (mel, encoder outputs, rolling prompt, timings)."""
        sub = copy.copy(self)
        sub.timings = Timings()
        sub.mel = None
        sub.n_len_org = 0
        sub.xk = sub.xv = None
        sub.batcher = None
        sub.prompt_past0, sub.prompt_past1 = [], []
        return sub

    def decode(self, tokens_2d: np.ndarray, n_past: int, cache):
        """Batched decode of (n_beam, n_tok) tokens at positions n_past..;
        returns (last-row logits (n_beam, n_vocab) numpy, updated cache)."""
        n_beam, n_tok = tokens_2d.shape
        bt = _bucket(n_tok)
        toks = np.zeros((n_beam, bt), np.int64)
        toks[:, :n_tok] = tokens_2d
        pos = np.clip(n_past + np.arange(bt), 0, self.hp.n_text_ctx - 1)[None, :]
        pos = pos.repeat(n_beam, 0)
        t0 = time.perf_counter()
        attn_ctx = next(a for a in M.attn_ctx_buckets(self.hp.n_text_ctx)
                        if a >= min(n_past + bt, self.hp.n_text_ctx))
        logits, cache = M.decode_step(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device), n_past, cache, self.xk,
            self.xv, self.hp, dtype=self.compute_dtype, attn_ctx=attn_ctx)
        out = logits[:, n_tok - 1].cpu().numpy()
        dt = int((time.perf_counter() - t0) * 1e6)
        if n_tok == 1 and n_beam == 1:
            self.timings.t_decode_us += dt
            self.timings.n_decode += 1
        elif n_tok < 16:
            self.timings.t_batchd_us += dt
            self.timings.n_batchd += n_tok
        else:
            self.timings.t_prompt_us += dt
            self.timings.n_prompt += n_tok
        return out, cache
