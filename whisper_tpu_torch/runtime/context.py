"""WhisperContext — device weights, the mel, encoder outputs, the KV cache
and phase timers (whisper_context + whisper_state, src/whisper.cpp:824-900).

Port of whisper_tpu/runtime/context.py.  The context runs on the CUDA card
unless the caller passes device="cpu"; with no card it raises instead of
carrying on on the CPU.  The compute type is bf16 on the card (as on the
TPU) and f32 on the CPU (as the JAX package off the TPU).

precision="ggml_cpu_f16" is the JAX package's parity mode: it emulates the
reference CPU backend's numerics (f16 weights and activations, f16 caches,
the f16 GELU table and, for q4_0/q5_0/q8_0 files, Q8_0 activation rows with
integer block dots, models/whisper/model.py `_mm_ggml_q`), so its
transcript can be diffed against the reference binary's.  It takes no
kernel, and on the card it computes inside decoding/graphs.py `full_f32`.

Every device section holds decoding/graphs.py's DEVICE_LOCK, so contexts
cloned for concurrent requests (`clone_state`, runtime/batching.py) can
run in threads of their own.

The mel, the encode and the window decode are spans (runtime/trace.py:
`seek.mel`, `encode` with `encode.issue` inside, `decode`), and the phase
timers take their durations from the spans' own clock reads; the waits
for DEVICE_LOCK and in the batcher's queue go to timers of their own.

On the card a full-window encode replays one CUDA graph of the encoder
(models/whisper/model.py `EncoderGraph`), captured at the context's first
such encode and shared with its clones; where `encoder_graph_key` says
no (the parity mode, imatrix capture weights, -ac) it runs op by op.
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import LogMel
from ..decoding import device_loop as DL
from ..decoding.graphs import DEVICE_LOCK, full_f32
from ..decoding.logits import LogitFilterTables
from ..models.whisper import model as M
from ..models.whisper.convert import params_from_numpy
from ..models.whisper.load import (WhisperModel, build_parity_overlay,
                                   build_qweight_overlay, load_model)
from ..ops.qmm import QWeight, pitch_qweight_t
from . import trace
from .timings import Timings

# token-count buckets for prompt decodes (steps are always 1)
TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 448)

# dense matmul weights: stored in the compute type on the device, since
# every product rounds its operands to it anyway (saves memory and a cast
# per call; biases, norms and embeddings stay f32)
_MATMUL_KEYS = {"qkv_w", "o_w", "mlp0_w", "mlp1_w", "xq_w", "xk_w", "xv_w",
                "xo_w", "conv1_w", "conv2_w"}


@dataclass
class ContextTimings(Timings):
    """The phase timers, the window loop's CUDA-graph captures (kept out of
    t_decode_us), the DTW passes (decoding/dtw.py, one per window), and
    the waits kept out of t_encode_us and t_decode_us: for DEVICE_LOCK,
    and a window decode's in the batcher's queue until its round is taken;
    n_encode_graph: the encodes that replayed the encoder's CUDA graph."""

    t_capture_us: int = 0
    n_capture: int = 0
    t_lock_wait_us: int = 0
    t_batch_wait_us: int = 0
    t_dtw_us: int = 0
    n_dtw: int = 0
    n_encode_graph: int = 0


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
                 cross_itype: str = "f16", precision: Optional[str] = None,
                 mel_backend: str = "auto"):
        if precision not in (None, "default", "ggml_cpu_f16"):
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
        self.parity = precision == "ggml_cpu_f16"
        self.compute_dtype = compute_dtype or (
            torch.float16 if self.parity else
            torch.bfloat16 if on_card else torch.float32)
        self.cache_dtype = torch.float16 if self.parity else torch.float32
        self.kv_itype = kv_itype
        self.cross_itype = cross_itype
        # packed path for quantized files: the decoder's hot matmuls and the
        # logits head stay block-quantized on the device as TRANSPOSED,
        # PER-LAYER planes for the streaming kernel (ops/qmm.py); the dense
        # leaves they replace are dropped.  Default on for the card, off on
        # the CPU (dense f32 there, as the JAX package off the TPU).
        if use_packed_weights is None:
            use_packed_weights = on_card
        self.use_packed_weights = bool(use_packed_weights and model.qparams
                                       and not self.parity)
        overlay = (build_qweight_overlay(model.qparams, self.hp)
                   if self.use_packed_weights else None)
        # the parity mode on a quantized file: every quantized matmul weight
        # and the token embedding become centred-code planes (QWGGML) for
        # the reference's integer block dots
        parity_overlay = (build_parity_overlay(model.qparams, self.hp)
                          if self.parity and model.qparams else None)
        with DEVICE_LOCK:
            self.params = (None if model.is_empty
                           else params_from_numpy(model.params, self.device))
            if overlay is not None:
                self._install_packed(overlay)
            if parity_overlay is not None:
                self._install_parity(parity_overlay)
            if self.params is not None and self.compute_dtype != torch.float32:
                self.params = _cast_matmul_weights(self.params, self.compute_dtype)

        # mel backend: "auto" runs the batched-rfft device mel on the card
        # (FFT rounding ~1e-6 relative from the reference-exact numpy path)
        # and the numpy mel on the CPU and in the parity mode, as the JAX
        # package takes its device mel only on the TPU outside that mode
        if mel_backend == "auto":
            mel_backend = "torch" if on_card and not self.parity else "numpy"
        self.mel_fn = LogMel(model.filters.data, backend=mel_backend,
                             device=self.device)
        self.timings = ContextTimings()
        self.filter_tables: Optional[LogitFilterTables] = None  # set per window
        self.mel: Optional[np.ndarray] = None       # (n_mel, n_len)
        self.n_len_org: int = 0
        self.lang_id: int = 0
        self.no_speech_prob: float = 0.0
        self.xk = None
        self.xv = None
        self._window_fns: Dict[Tuple, object] = {}
        self._encoder_graphs: Dict[Tuple, M.EncoderGraph] = {}
        # [EXPERIMENTAL] DTW token-level timestamps
        # (whisper_context_params.dtw_*, include/whisper.h:116-129)
        self.dtw_token_timestamps = False
        self.dtw_aheads: Optional[list] = None
        # a WindowBatcher (runtime/batching.py) that window decodes join;
        # None: each runs at once
        self.batcher = None

    def enable_dtw(self, preset: str = "auto", n_top_most: int = 0,
                   custom=None) -> None:
        """Select alignment heads and enable DTW timestamps
        (aheads_masks_init, src/whisper.cpp:1160-1283)."""
        from ..decoding.dtw import resolve_aheads

        if preset == "auto":
            preset = self.hp.model_name
            if not self.vocab.is_multilingual:
                preset += ".en"
        # the reference CLI spells these with dots (cli.cpp:190-213)
        preset = preset.replace("large.v", "large-v").replace(
            "large-v3.turbo", "large-v3-turbo")
        self.dtw_aheads = resolve_aheads(self.hp, preset, n_top_most, custom)
        self.dtw_token_timestamps = True

    def _install_packed(self, overlay) -> None:
        dev = self.device

        def planes_t(codes, scales, mins):
            # transposed (K, R) planes, rows pitched for the streaming kernel
            tr = lambda a: None if a is None else a.T
            return pitch_qweight_t(tr(codes), tr(scales), tr(mins), device=dev)

        n_layers = self.hp.n_text_layer
        blocks_packed = [dict() for _ in range(n_layers)]
        for key, (codes, scales, mins) in overlay["blocks"].items():
            for l in range(n_layers):
                blocks_packed[l][key] = planes_t(
                    codes[l], scales[l], None if mins is None else mins[l])
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
            self.params["dec"]["tok_embd_t"] = planes_t(codes, scales, mins)

    def _install_parity(self, overlay) -> None:
        def planes(codes, scales):
            return M.QWGGML(*(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device, torch.float32) for a in (codes, scales)))

        for part, key in (("enc", "enc_blocks"), ("dec", "dec_blocks")):
            for k, (codes, scales) in overlay[key].items():
                self.params[part]["blocks"][k] = planes(codes, scales)
        self.params["dec"]["tok_embd"] = planes(*overlay["tok_embd"])

    def numerics(self):
        """The context the parity mode computes in on the card
        (graphs.full_f32: no TF32, no reduced-precision f16 reductions);
        nothing otherwise.  Enter it under DEVICE_LOCK."""
        return full_f32() if self.parity else contextlib.nullcontext()

    @staticmethod
    def from_file(path: str, **kw) -> "WhisperContext":
        return WhisperContext(load_model(path), **kw)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- mel -----------------------------------------------------------------

    def pcm_to_mel(self, samples: np.ndarray) -> None:
        with trace.timed("seek.mel") as sp:
            self.mel, self.n_len_org = self.mel_fn(samples)
        self.timings.t_mel_us += sp.ns // 1000

    def set_mel(self, mel: np.ndarray, n_len_org: Optional[int] = None) -> None:
        """whisper_set_mel: a caller's (n_mel, n_len) mel in place of
        pcm_to_mel's."""
        self.mel = np.asarray(mel, dtype=np.float32)
        self.n_len_org = n_len_org if n_len_org is not None else mel.shape[1]

    @property
    def n_len(self) -> int:
        return 0 if self.mel is None else self.mel.shape[1]

    # -- public compute ---------------------------------------------------------

    def encode_window(self, seek: int, audio_ctx: int = 0) -> None:
        """Encode 2*n_ctx mel frames starting at `seek`
        (whisper_encode_internal, src/whisper.cpp:2364-2462).

        One `M.encode` call a window, under DEVICE_LOCK; where it replays
        the encoder's graph its result is the graph's static output, which
        the next window's replay overwrites, so the cross K/V is computed
        from it inside the same hold of the lock.  The `encode` span's
        attribute `graph` is 1 for a replay, 0 for an encode op by op."""
        assert self.mel is not None, "call pcm_to_mel first"
        hp = self.hp
        n_ctx = audio_ctx if audio_ctx > 0 else hp.n_audio_ctx
        with trace.timed("encode") as sp:
            window = np.zeros((hp.n_mels, 2 * n_ctx), np.float32)
            i1 = min(seek + 2 * n_ctx, self.n_len)
            if i1 > seek:
                window[:, : i1 - seek] = self.mel[:, seek:i1]
            with DEVICE_LOCK.timed() as held, self.numerics():
                graph = self._encoder_graph(n_ctx)
                with trace.span("encode.issue"):
                    enc = M.encode(self.params, torch.from_numpy(window).to(self.device),
                                   hp, dtype=self.compute_dtype, parity=self.parity,
                                   graph=graph)
                    self.xk, self.xv = M.compute_cross_kv(
                        self.params, enc, hp, dtype=self.compute_dtype,
                        itype=self.cross_itype, parity=self.parity)
                self._sync()
            # max_initial_ts precision derives from the MODEL's full audio ctx
            # (src/whisper.cpp:6338)
            self.filter_tables = LogitFilterTables(self.vocab, hp.n_audio_ctx)
            sp.attrs = {"graph": int(graph is not None)}
        self.timings.t_encode_us += (sp.ns - held.wait_ns) // 1000
        self.timings.t_lock_wait_us += held.wait_ns // 1000
        self.timings.n_encode += 1
        self.timings.n_encode_graph += graph is not None

    def _encoder_graph(self, n_ctx: int) -> Optional[M.EncoderGraph]:
        """The encoder's graph for this window (None: encode op by op),
        captured at first use and shared with the clones.  Hold
        DEVICE_LOCK."""
        key = M.encoder_graph_key(self.params, self.hp, n_ctx, self.compute_dtype,
                                  self.device, self.parity)
        if key is None:
            return None
        graph = self._encoder_graphs.get(key)
        if graph is None:
            graph = self._encoder_graphs[key] = M.EncoderGraph(
                self.params, self.hp, self.compute_dtype, self.device)
        return graph

    def new_cache(self, n_beam: int, dtype=None):
        with DEVICE_LOCK:
            return M.new_cache(self.hp, n_beam, dtype or self.cache_dtype,
                               itype=self.kv_itype, device=self.device)

    def decode_window_device(self, prompt, n_beams: int, temperature: float,
                             seek: int, seek_end: int, params,
                             no_timestamps: bool, rng_seed: int,
                             strategy: str = "greedy") -> DL.WindowResult:
        """Decode a whole window with the token-loop state on the device
        (decoding/device_loop.py), with the window strategy "greedy" or
        "beam"; returns a WindowResult of numpy arrays.

        With a WindowBatcher attached (runtime/batching.py) the request
        joins the current lockstep batch instead of running at once.
        t_decode_us leaves out the graphs captured for the call, its waits
        for DEVICE_LOCK (its round's, where another thread ran it) and its
        wait in the batcher's queue."""
        with trace.timed("decode") as sp:
            res, (n_graphs, capture_us), lock_ns, batch_ns = self._decode_window(
                prompt, n_beams, temperature, seek, seek_end, params,
                no_timestamps, rng_seed, strategy)
        # the graphs captured for this call count apart from decode time (a
        # batched group's, once: on its first request)
        self.timings.t_decode_us += (sp.ns - lock_ns - batch_ns) // 1000 - capture_us
        self.timings.t_lock_wait_us += lock_ns // 1000
        self.timings.t_batch_wait_us += batch_ns // 1000
        self.timings.t_capture_us += capture_us
        self.timings.n_capture += n_graphs
        self.timings.n_decode += int(res.n_tok.max()) if res.n_tok.size else 0
        self.timings.n_prompt += len(prompt)
        return res

    def _decode_window(self, prompt, n_beams, temperature, seek, seek_end, params,
                       no_timestamps, rng_seed, strategy):
        """decode_window_device's work: (its result, (graphs, µs) captured,
        ns waited for DEVICE_LOCK, ns waited in the batcher's queue)."""
        bt = _bucket(len(prompt))
        # key[:5] picks the decoder; the digest keeps the batcher from
        # coalescing requests whose arguments differ where _run_group takes
        # them from the first request (suppression masks, max_tokens) or
        # cannot stack (cross-K/V shapes under -ac): without it concurrent
        # server users would decode with each other's masks
        digest = (params.suppress_blank, params.suppress_nst,
                  params.suppress_regex, params.tdrz_enable,
                  params.max_initial_ts, params.max_tokens,
                  tuple(DL._planes(self.xk)[0].shape))
        key = (n_beams, bt, no_timestamps, params.single_segment, strategy,
               digest)
        base_mask, initial_mask = DL.build_masks(self.filter_tables, params)
        prompt_padded = np.zeros(bt, np.int64)
        prompt_padded[: len(prompt)] = prompt
        dev = self.device
        with DEVICE_LOCK.timed() as held:
            args = (torch.from_numpy(prompt_padded).to(dev), len(prompt),
                    self.xk, self.xv, torch.from_numpy(base_mask).to(dev),
                    torch.from_numpy(initial_mask).to(dev), float(temperature),
                    int(seek), int(seek_end), int(params.max_tokens), rng_seed)
        lock_ns = held.wait_ns
        if self.batcher is None:
            with DEVICE_LOCK.timed() as held:
                res, capture = self._decode_window_exec(key, *args)
            return res, capture, lock_ns + held.wait_ns, 0
        lock0, batch0 = trace.waits()
        res, capture = self.batcher.submit(key, args)
        lock1, batch1 = trace.waits()
        return res, capture, lock_ns + lock1 - lock0, batch1 - batch0

    def window_decoder(self, key, n_windows: int = 1):
        """The window decoder for key[:5], one window or `n_windows`
        natively batched, built at first use and shared with the clones."""
        dkey = key[:5] if n_windows == 1 else (key[:5], "native", n_windows)
        fn = self._window_fns.get(dkey)
        if fn is None:
            n_beams, bt, no_timestamps, single_segment, strategy = key[:5]
            fn = self._window_fns[dkey] = DL.make_window_decoder(
                self.hp, n_beams, bt, self.compute_dtype, no_timestamps,
                single_segment, self.vocab.token_eot, self.vocab.token_beg,
                kv_itype=self.kv_itype, strategy=strategy, n_windows=n_windows,
                parity=self.parity)
        return fn

    def _decode_window_exec(self, key, *args) -> Tuple[DL.WindowResult,
                                                       Tuple[int, int]]:
        """Run one window decode for `key` now, unbatched: (its result,
        (graphs, µs) its decoder captured during this call)."""
        with DEVICE_LOCK:
            fn = self.window_decoder(key)
            before = fn.graphs, fn.capture_us
            res = fn(self.params, *args)
            return res, (fn.graphs - before[0], fn.capture_us - before[1])

    def clone_state(self) -> "WhisperContext":
        """A shallow clone sharing weights but with its own per-stream state
        (mel, encoder outputs, rolling prompt, timings)."""
        sub = copy.copy(self)
        sub.timings = ContextTimings()
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
        with DEVICE_LOCK, self.numerics():
            logits, cache = M.decode_step(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos).to(self.device), n_past, cache, self.xk,
                self.xv, self.hp, dtype=self.compute_dtype, attn_ctx=attn_ctx,
                parity=self.parity)
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
