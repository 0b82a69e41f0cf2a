"""TDT greedy transducer decode (reference: parakeet_decode,
src/parakeet.cpp:2496-2640).

Port of whisper_tpu/models/parakeet/decode.py.  The JAX package runs the
whole frame loop on the device as one `lax.while_loop`, and a batch as its
vmap.  Here the loop state is a `TdtState` of tensors at fixed addresses
(t, n_out, emitted, pred_out, h, c, the per-row caps and the output rows)
and one step function updates it in place for B rows at once: the joint
logits, the greedy argmax over vocab + blank, the duration, the LSTM update
and the token's row, both branches computed and chosen per row with
`torch.where`, so a step holds no host value.  A row stops on its own
(t >= its frame count, or its output cap reached) and later steps leave it
as it is; the loop ends when every row has.

On the CUDA card STEPS_PER_REPLAY steps are one captured CUDA graph
(decoding/graphs.py CountedGraph) per (rows, frame bucket, output bucket,
logit capture), and the host replays it and reads the "all rows done" flag
after each replay: the counterpart of the while_loop's condition.  `enc`
sits in a buffer of a power-of-two frame bucket, so one capture serves
every length up to it.  On the CPU the same step runs eagerly, with the
same flag reads; `TdtLoop.run(..., eager=True)` runs the eager loop on the
card too (the graphs' reference).

`chunk` = k > 1 is the JAX package's chunked loop (`_tdt_greedy_decode_
chunked`, which it measured and left off by default; `chunk = 1`, the frame
loop, stays the default here too).  It is reference-only, kept for parity
with the JAX surface: no caller of the port selects it, and on the H100 it
is slower than the frame loop (PERF.md).  Blank frames do not touch the
prediction network, so a step scores the k frames from t on against the
current pred_out in one batched joint product (the joint's encoder half,
`model.joint_enc`, hoisted over every frame before the loop; the rest,
`model.joint_out`, is the frame loop's) and walks the duration-skip chain
through them with k unrolled vector steps, to the first emission or past
the k frames: about one step per emitted token instead of one per frame.
Its step (`tdt_step_chunked`) is captured and replayed as the frame loop's
is.

Kept from the JAX loop: a blank advances t by max(dur, 1); after
n_max_tokens emissions without an advance t is forced forward by one;
p = exp(max_logit - logsumexp) in f32; max_out = max(16, min(n *
n_max_tokens, 4n + 64)); the joint-logit row of each emitted token when
capture_logits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from ...decoding import graphs as CG
from . import model as M
from .hparams import ParakeetHParams
from .tokenizer import is_punctuation_token, is_word_start_token

STEPS_PER_REPLAY = 8   # loop steps per captured graph, between flag reads


@dataclass
class ParakeetTokenData:
    """parakeet_token_data (include/parakeet.h:120-137)."""

    id: int
    duration_idx: int
    duration_value: int
    frame_index: int
    p: float
    plog: float
    t0: int
    t1: int
    is_word_start: bool = False


def max_out_for(n_frames: int, hp: ParakeetHParams) -> int:
    """The JAX loop's output cap for an utterance of n_frames frames."""
    return max(16, int(min(n_frames * hp.n_max_tokens, 4 * n_frames + 64)))


def _bucket(n: int, least: int) -> int:
    return max(least, 1 << (max(n, 1) - 1).bit_length())


class TdtState:
    """The loop's tensors for B rows, an enc buffer of `n_cap` frames and
    output rows of `out_cap` tokens plus one spare column, which takes the
    writes of the rows that emit nothing in a step."""

    def __init__(self, hp: ParakeetHParams, B: int, n_cap: int, out_cap: int,
                 capture_logits: bool, dtype, device, chunk: int = 1, n_joint: int = 0):
        z = lambda *s, dt=torch.long: torch.zeros(s, dtype=dt, device=device)
        D, L = hp.n_pred_dim, hp.n_pred_layers
        self.enc = z(B, n_cap, hp.n_audio_state, dt=dtype)
        # chunked loop: the joint's encoder half of every frame, k rows of
        # padding past the buffer so that a chunk's rows stay in bounds
        self.enc_proj = z(B, n_cap + chunk, n_joint, dt=dtype) if chunk > 1 else None
        self.n_frames, self.max_out = z(B), z(B)
        self.t, self.n_out, self.emitted = z(B), z(B), z(B)
        self.pred_out = z(B, D, dt=dtype)
        self.h, self.c = z(B, L, D, dt=dtype), z(B, L, D, dt=dtype)
        self.tok, self.frame, self.didx, self.dval = (z(B, out_cap + 1) for _ in range(4))
        self.p, self.plog = z(B, out_cap + 1, dt=torch.float32), z(B, out_cap + 1, dt=torch.float32)
        self.logits = (z(B, out_cap + 1, hp.n_joint_out, dt=torch.float32)
                       if capture_logits else None)
        self.done = z(dt=torch.bool)
        self.durations = torch.tensor(hp.tdt_durations, dtype=torch.long, device=device)
        self.out_cap = out_cap
        self.chunk = chunk


def tdt_step(st: TdtState, params: Dict[str, Any], hp: ParakeetHParams, dtype) -> None:
    """One step of the frame loop for every row, in place (the JAX loop's
    body, both branches computed and selected per row)."""
    joint_p = params["joint"]
    blank_id = hp.blank_id
    nv = blank_id + 1
    B, n_cap, S = st.enc.shape
    t, n_out, emitted = st.t, st.n_out, st.emitted
    active = (t < st.n_frames) & (n_out < st.max_out)

    ti = t.clamp(max=n_cap - 1)
    enc_t = st.enc.gather(1, ti[:, None, None].expand(B, 1, S))[:, 0]
    logits = M.joint_logits(joint_p, enc_t, st.pred_out, dtype)
    tok_logits = logits[:, :nv].float()
    dur_logits = logits[:, nv:].float()
    best_tok = tok_logits.argmax(-1)
    max_logit = tok_logits.gather(1, best_tok[:, None])[:, 0]
    didx = dur_logits.argmax(-1)
    dur = st.durations[didx]
    emit = active & (best_tok != blank_id)
    blank = active & (best_tok == blank_id)

    _advance(st, params, hp, dtype, emit, blank, logits, tok_logits, best_tok, max_logit,
             didx, dur, t, emitted, t + dur.clamp(min=1))


def _advance(st: TdtState, params, hp: ParakeetHParams, dtype, emit, blank, logits,
             tok_logits, best_tok, max_logit, didx, dur, t_at, emitted, t_blank) -> None:
    """The end of a step, per row: an emitting row (`emit`) writes its
    token's row at n_out, takes the predictor's step and moves t from the
    emission's frame `t_at` by the duration (forced on by one after
    n_max_tokens emissions without an advance, counting from `emitted`); a
    row of blanks only (`blank`) moves to `t_blank` and resets the count;
    any other row stays.  Then the "all rows done" flag."""
    B = st.t.shape[0]
    n_out = st.n_out
    p = torch.exp(max_logit - torch.logsumexp(tok_logits, dim=-1))
    pred2, h2, c2 = M.lstm_predict(params["pred"], params["joint"], best_tok, st.h, st.c,
                                   hp, dtype)
    adv = dur > 0
    em2 = torch.where(adv, 0, emitted + 1)
    force = (~adv) & (em2 >= hp.n_max_tokens)
    t_emit = torch.where(adv, t_at + dur, torch.where(force, t_at + 1, t_at))
    em2 = torch.where(force, 0, em2)

    slot = torch.where(emit, n_out, st.out_cap)[:, None]
    for buf, val in ((st.tok, best_tok), (st.frame, t_at), (st.didx, didx),
                     (st.dval, dur), (st.p, p), (st.plog, max_logit)):
        buf.scatter_(1, slot, val[:, None].to(buf.dtype))
    if st.logits is not None:
        st.logits.scatter_(1, slot[:, :, None].expand(B, 1, logits.shape[1]),
                           logits[:, None].float())

    t_new = torch.where(emit, t_emit, torch.where(blank, t_blank, st.t))
    emitted_new = torch.where(emit, em2, torch.where(blank, 0, st.emitted))
    n_out_new = torch.where(emit, n_out + 1, n_out)
    e = emit[:, None]
    st.pred_out.copy_(torch.where(e, pred2, st.pred_out))
    st.h.copy_(torch.where(e[:, :, None], h2, st.h))
    st.c.copy_(torch.where(e[:, :, None], c2, st.c))
    st.t.copy_(t_new)
    st.emitted.copy_(emitted_new)
    st.n_out.copy_(n_out_new)
    st.done.copy_(~((t_new < st.n_frames) & (n_out_new < st.max_out)).any())


def tdt_step_chunked(st: TdtState, params: Dict[str, Any], hp: ParakeetHParams,
                     dtype) -> None:
    """One step of the chunked loop for every row, in place (the JAX
    `_tdt_greedy_decode_chunked` body): the joint over the k = st.chunk
    frames from t on against the current pred_out, the duration-skip walk
    through them, then an emission at t + off or, if every visited frame
    was blank, t + off."""
    joint_p = params["joint"]
    K, nv = st.chunk, hp.blank_id + 1
    B, _, J = st.enc_proj.shape
    t = st.t
    active = (t < st.n_frames) & (st.n_out < st.max_out)

    idx = t.clamp(max=st.enc.shape[1])[:, None] + torch.arange(K, device=t.device)
    rows = st.enc_proj.gather(1, idx[:, :, None].expand(B, K, J))
    logits_k = M.joint_out(joint_p, rows, st.pred_out[:, None], dtype)  # (B, K, n_joint_out)
    tok_k = logits_k[..., :nv].argmax(-1)
    didx_k = logits_k[..., nv:].argmax(-1)
    dur_k = st.durations[didx_k]
    blank_k = tok_k == hp.blank_id

    # each blank advances at least one frame, so k unrolled steps resolve
    # the chunk
    off = torch.zeros_like(t)
    emit = torch.zeros_like(active)
    done = ~active
    for _ in range(K):
        offc = off.clamp(max=K - 1)[:, None]
        cur_blank = blank_k.gather(1, offc)[:, 0]
        cur_dur = dur_k.gather(1, offc)[:, 0]
        visit = (~done) & (t + off < st.n_frames) & (off < K)
        is_emit = visit & ~cur_blank
        emit = emit | is_emit
        done = done | is_emit | ~visit
        off = torch.where(visit & cur_blank, off + cur_dur.clamp(min=1), off)

    offc = off.clamp(max=K - 1)
    logits = logits_k.gather(1, offc[:, None, None].expand(B, 1, logits_k.shape[2]))[:, 0]
    tok_logits = logits[:, :nv].float()
    best_tok = tok_k.gather(1, offc[:, None])[:, 0]
    max_logit = tok_logits.gather(1, best_tok[:, None])[:, 0]
    didx = didx_k.gather(1, offc[:, None])[:, 0]
    # blanks visited before the emission reset the emission count
    emitted = torch.where(off > 0, 0, st.emitted)
    _advance(st, params, hp, dtype, emit, active & ~emit, logits, tok_logits, best_tok,
             max_logit, didx, st.durations[didx], t + off, emitted, t + off)


class TdtLoop:
    """The frame loop over one parameter tree: a TdtState and, on the card,
    a captured graph of STEPS_PER_REPLAY steps per (rows, frame bucket,
    output bucket, logit capture).  Counters: `runs`, `replays` (graph
    replays, or eager blocks of STEPS_PER_REPLAY steps), `flag_reads`,
    `steps` (steps run, those past every row's end included), `graphs` and
    `capture_us`."""

    def __init__(self, params: Dict[str, Any], hp: ParakeetHParams,
                 dtype=torch.float32):
        self.params, self.hp, self.dtype = params, hp, dtype
        self.held: Dict[tuple, list] = {}
        self.pool = None
        self.runs = self.replays = self.flag_reads = self.steps = 0
        self.graphs = self.capture_us = 0

    def _state(self, B: int, n_cap: int, out_cap: int, capture: bool, dev,
               on_graphs: bool, chunk: int):
        key = (B, n_cap, out_cap, capture, chunk)
        held = self.held.get(key)
        if held is None:
            held = self.held[key] = [TdtState(
                self.hp, B, n_cap, out_cap, capture, self.dtype, dev, chunk,
                self.params["joint"]["enc_w"].shape[0]), None]
        st = held[0]
        step = tdt_step if chunk == 1 else tdt_step_chunked
        if on_graphs and held[1] is None:
            t0 = time.perf_counter()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()

            def block():
                for _ in range(STEPS_PER_REPLAY):
                    step(st, self.params, self.hp, self.dtype)

            held[1] = CG.CountedGraph(block, self.pool)
            torch.cuda.synchronize(dev)
            self.graphs += 1
            self.capture_us += int((time.perf_counter() - t0) * 1e6)
        return st, held[1] if on_graphs else None, step

    def run(self, enc: torch.Tensor, n_frames, h0: torch.Tensor, c0: torch.Tensor,
            max_out, capture_logits: bool = False, eager: bool = False, chunk: int = 1):
        """Decode B rows: enc [B, T, S] on the loop's device, n_frames and
        max_out sequences of B ints, h0/c0 [B, L, D]; `chunk` > 1 takes the
        chunked loop.  Returns numpy (tok, frame, didx, dval, p, plog)
        [B, max(max_out)], n_out [B], the final h and c as tensors, and the
        logit rows (or None)."""
        hp, dev = self.hp, enc.device
        B, T, _ = enc.shape
        n_cap = _bucket(T, 64)
        out_cap = _bucket(max(max_out), 16)
        on_graphs = dev.type == "cuda" and not eager
        if chunk < 1:
            raise ValueError(f"chunk must be at least 1, got {chunk}")
        with CG.DEVICE_LOCK, CG.full_f32():
            st, graph, step = self._state(B, n_cap, out_cap, capture_logits, dev, on_graphs,
                                          chunk)
            st.enc.zero_()
            st.enc[:, :T].copy_(enc)
            if st.enc_proj is not None:
                # the joint's encoder half for every frame, once (the padded
                # frames' rows are never visited)
                st.enc_proj[:, :n_cap].copy_(M.joint_enc(self.params["joint"], st.enc,
                                                         self.dtype))
            st.n_frames.copy_(torch.as_tensor(list(n_frames), dtype=torch.long))
            st.max_out.copy_(torch.as_tensor(list(max_out), dtype=torch.long))
            for a in (st.t, st.n_out, st.emitted, st.done):
                a.zero_()
            # initial predict on the blank token (src/parakeet.cpp:2525-2536)
            blank = torch.full((B,), hp.blank_id, dtype=torch.long, device=dev)
            pred_out, h, c = M.lstm_predict(self.params["pred"], self.params["joint"],
                                            blank, h0, c0, hp, self.dtype)
            st.pred_out.copy_(pred_out)
            st.h.copy_(h)
            st.c.copy_(c)
            # each live step advances t or emits, so this many blocks end it
            for _ in range(-(-(n_cap + out_cap) // STEPS_PER_REPLAY) + 1):
                if graph is not None:
                    graph.replay()
                else:
                    for _ in range(STEPS_PER_REPLAY):
                        step(st, self.params, hp, self.dtype)
                self.replays += 1
                self.steps += STEPS_PER_REPLAY
                self.flag_reads += 1
                if bool(st.done):
                    break
            else:
                raise RuntimeError("TDT loop did not end")
            self.runs += 1
            m = max(max_out)
            outs = [a[:, :m].cpu().numpy() for a in (st.tok, st.frame, st.didx,
                                                     st.dval, st.p, st.plog)]
            logits = None if st.logits is None else st.logits[:, :m].cpu().numpy()
            return (*outs, st.n_out.cpu().numpy(), st.h.clone(), st.c.clone(), logits)


def tdt_greedy_decode(loop: TdtLoop, enc: torch.Tensor, n_frames: int,
                      h0: torch.Tensor, c0: torch.Tensor, max_out: int,
                      capture_logits: bool = False, eager: bool = False, chunk: int = 1):
    """One utterance (the JAX `tdt_greedy_decode`): enc [T, S], h0/c0 [L, D];
    `chunk` > 1 takes the chunked loop.  Returns (tokens, frame_idx, dur_idx,
    dur_val, p, plog, n_out, h, c), plus the joint-logit rows [max_out,
    n_joint_out] when capture_logits."""
    out = loop.run(enc[None], [n_frames], h0[None], c0[None], [max_out],
                   capture_logits, eager, chunk)
    res = (*(a[0] for a in out[:6]), int(out[6][0]), out[7][0], out[8][0])
    return res + (out[9][0],) if capture_logits else res


def tdt_greedy_decode_batch(loop: TdtLoop, enc_b: torch.Tensor, n_frames_b,
                            h0_b: torch.Tensor, c0_b: torch.Tensor, max_out: int,
                            eager: bool = False, chunk: int = 1):
    """The JAX `tdt_greedy_decode_batch` (its vmap as the row axis): every
    row under the same max_out; `chunk` > 1 takes the chunked loop, each row
    walking its own chunks.  Returns (tok, frame, didx, dval, p, plog, n_out,
    h, c), each with a leading row axis."""
    return loop.run(enc_b, list(n_frames_b), h0_b, c0_b, [max_out] * enc_b.shape[0],
                    eager=eager, chunk=chunk)[:9]


def unpack_token_data(vocab, sub: int, tok, frame, didx, dval, p, plog,
                      n: int) -> List[ParakeetTokenData]:
    """Host-side unpack of the device loop's packed result arrays into
    parakeet_token_data records (include/parakeet.h:120-137)."""
    tok, frame = np.asarray(tok[:n]), np.asarray(frame[:n])
    didx, dval = np.asarray(didx[:n]), np.asarray(dval[:n])
    p, plog = np.asarray(p[:n]), np.asarray(plog[:n])
    out = []
    for i in range(n):
        out.append(ParakeetTokenData(
            id=int(tok[i]), duration_idx=int(didx[i]),
            duration_value=int(dval[i]), frame_index=int(frame[i]),
            p=float(p[i]), plog=float(plog[i]),
            t0=int(frame[i]) * sub, t1=(int(frame[i]) + int(dval[i])) * sub,
            is_word_start=is_word_start_token(vocab, int(tok[i]))))
    return out


class TdtDecoder:
    """Host wrapper: runs the loop, unpacks parakeet_token_data, and keeps
    the LSTM state between calls (parakeet_chunk's streaming state)."""

    def __init__(self, model, params: Dict[str, Any], device, dtype=torch.float32,
                 loop: TdtLoop = None):
        self.model = model
        self.hp = model.hparams
        self.dtype = dtype
        self.params = params
        self.loop = loop or TdtLoop(params, self.hp, dtype)
        D, L = self.hp.n_pred_dim, self.hp.n_pred_layers
        with CG.DEVICE_LOCK:
            self.h = torch.zeros((L, D), dtype=dtype, device=device)
            self.c = torch.zeros((L, D), dtype=dtype, device=device)
        self.last_logits: Any = None  # np [n_out, n_joint_out] when captured

    def clone(self) -> "TdtDecoder":
        """A fresh-LSTM decoder sharing the weights and the loop's graphs —
        the per-state half of parakeet_init_state (include/parakeet.h:93)."""
        return TdtDecoder(self.model, self.params, self.h.device, self.dtype, self.loop)

    def reset_state(self) -> None:
        """parakeet_reset_state LSTM clear (src/parakeet.cpp:3552-3560)."""
        with CG.DEVICE_LOCK:
            self.h = torch.zeros_like(self.h)
            self.c = torch.zeros_like(self.c)

    def decode(self, enc: torch.Tensor, n_frames: int,
               capture_logits: bool = False) -> List[ParakeetTokenData]:
        """enc [T, S] on the device (T >= n_frames)."""
        out = tdt_greedy_decode(self.loop, enc, n_frames, self.h, self.c,
                                max_out_for(n_frames, self.hp), capture_logits)
        tok, frame, didx, dval, p, plog, n_out, self.h, self.c = out[:9]
        if capture_logits:
            self.last_logits = out[9][:n_out]
        return unpack_token_data(self.model.vocab, self.hp.subsampling_factor,
                                 tok, frame, didx, dval, p, plog, n_out)


def refine_timestamps_tdt(vocab, tokens: List[ParakeetTokenData]) -> None:
    """Collapse punctuation-token durations (src/parakeet.cpp:2449-2471)."""
    last_t1 = -1
    for td in tokens:
        if is_punctuation_token(vocab, td.id):
            if last_t1 >= 0:
                td.t0 = last_t1
                td.t1 = last_t1
        else:
            last_t1 = td.t1
