"""Whisper fine-tuning: teacher-forced cross-entropy over the decoder.

Port of whisper_tpu/training/finetune.py on torch autograd.  The reference
ships ggml-opt as a generic training layer that whisper.cpp itself never
wires up; this module fine-tunes a loaded whisper checkpoint on
(mel, token-sequence) pairs with the generic `training.opt` machinery, then
writes a standard legacy-ggml model file back out (readable by this
runtime, the JAX package and the reference `whisper_model_load`).

Design notes:
  * the forward is the production graph — `model.encode` +
    `model.compute_cross_kv` + one whole-sequence `model.decode_step`
    (teacher forcing IS a single causal decoder pass over the target
    tokens, kv_head=0 on a fresh f32 cache), in f32, so there is no separate
    "training model" to diverge from inference.  f32 takes none of the
    port's kernels: the encoder's attention takes the plain graph
    (models/whisper/model.py `_enc_attn_route`), dense weights skip the
    decode matmul, an f32 cache skips the decode attention;
  * decode_step writes each layer's new K/V into the cache in place
    (index_copy_); the cache here holds each layer in a tensor of its own
    (`_LayerCells`), so a later layer's write leaves the views an earlier
    layer's attention saved for backward untouched, and the gradient flows
    through every write into the K/V weights;
  * `freeze_encoder=True` trains only the decoder (the common adaptation
    recipe) by zeroing the encoder's gradients, as the JAX package does;
    the encoder then runs under torch.no_grad() (its gradient is zero
    either way), and its weights still take the optimizer's decay;
  * memory: each sample's forward runs under torch.utils.checkpoint (the
    counterpart of jax.checkpoint), so activations are recomputed in the
    backward instead of living across the whole batch;
  * padding: positions with label -100 are masked out of the loss
    (converters emit fixed-length rows padded with -100);
  * precision on the card: OptContext runs every step's forward and
    backward inside decoding/graphs.py `full_f32` (IEEE f32 products, no
    TF32) under DEVICE_LOCK, so a step on the card computes what it
    computes on the CPU up to the order of f32 sums;
  * data parallelism (`mesh=`, its "dp" axis): each rank runs its rows of
    the batch (OptContext), and the loss's mean divides by the whole
    batch's count of scored positions (summed over the axis, a constant to
    autograd), so the summed loss and gradients are one process's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.whisper import model as M
from ..models.whisper.hparams import WhisperHParams
from ..models.whisper.load import WhisperModel
from ..models.whisper.writer import write_model_file
from ..parallel.mesh import all_reduce_sum
from .opt import OptContext, OptimizerParams, dp_group

IGNORE_INDEX = -100


class _LayerCells(tuple):
    """A self-attention cache's layers as separate (B, H, 2, C, d) tensors:
    `KVCache.kv` as decode_step indexes it (kv[l], .shape, .dtype)."""

    @property
    def shape(self):
        return (len(self),) + tuple(self[0].shape)

    @property
    def dtype(self):
        return self[0].dtype


def _fresh_cache(hp: WhisperHParams, device) -> M.KVCache:
    h = hp.n_text_head
    shape = (1, h, 2, hp.n_text_ctx, hp.n_text_state // h)
    return M.KVCache(_LayerCells(torch.zeros(shape, dtype=torch.float32, device=device)
                                 for _ in range(hp.n_text_layer)))


def _decode_one(params, enc, toks, hp, dtype):
    xk, xv = M.compute_cross_kv(params, enc, hp, dtype=dtype)
    n = toks.shape[0]
    logits, _ = M.decode_step(
        params, toks[None], torch.arange(n, device=toks.device)[None], 0,
        _fresh_cache(hp, toks.device), xk, xv, hp, dtype=dtype,
        attn_ctx=_ctx_bucket(n, hp.n_text_ctx))
    return logits[0]


def _forward_one(params, mel1, toks, hp, dtype):
    return _decode_one(params, M.encode(params, mel1, hp, dtype=dtype), toks, hp, dtype)


def teacher_forced_logits(params: Dict[str, Any], mel: torch.Tensor,
                          tokens: torch.Tensor, hp: WhisperHParams,
                          dtype=torch.float32,
                          freeze_encoder: bool = False) -> torch.Tensor:
    """Logits for every position of `tokens` (B, T) given `mel`
    (B, n_mels, 2*n_audio_ctx): encode, precompute cross-KV, and run ONE
    causal decoder pass per sample (kv_head=0, fresh cache) — the training
    view of the inference graph.  Each sample's forward is checkpointed;
    with `freeze_encoder` the encoder runs outside it, without a graph."""
    out = []
    for mel1, toks in zip(mel, tokens):
        if freeze_encoder:
            with torch.no_grad():
                enc = M.encode(params, mel1, hp, dtype=dtype)
            out.append(checkpoint(_decode_one, params, enc, toks, hp, dtype,
                                  use_reentrant=False))
        else:
            out.append(checkpoint(_forward_one, params, mel1, toks, hp, dtype,
                                  use_reentrant=False))
    return torch.stack(out)


def _ctx_bucket(n_tok: int, n_ctx: int) -> int:
    """Smallest 128-multiple covering the sequence (static per shape)."""
    return min(n_ctx, ((n_tok + 127) // 128) * 128)


def masked_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   dp=None) -> torch.Tensor:
    """Mean CE over positions whose label != IGNORE_INDEX.  dp: a
    data-parallel group; the rows are this rank's, and the mean divides by
    the count over the group."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = torch.take_along_dim(logp, safe[..., None], dim=-1)[..., 0]
    return -torch.sum(torch.where(valid, tok_lp, 0.0)) / torch.clamp(
        all_reduce_sum(torch.sum(valid), dp), min=1)


def make_finetune_context(wm: WhisperModel,
                          optimizer: str = "adamw",
                          opt_period: int = 1,
                          get_opt_pars=None,
                          freeze_encoder: bool = True,
                          mesh=None,
                          dtype=torch.float32,
                          device=None) -> OptContext:
    """OptContext whose model_fn maps {mel, tokens} -> masked CE loss, its
    parameters the model's in f32 on `device` (the CUDA card unless
    "cpu").

    Inputs to step(): a dict {"mel": (B, n_mels, 2*n_ctx) f32,
    "tokens": (B, T+1) int32} — tokens[:, :-1] feed the decoder and
    tokens[:, 1:] are the labels (IGNORE_INDEX-padded).  The loss is built
    inside model_fn, so OptContext runs with LOSS_SUM on the scalar.
    """
    hp = wm.hparams
    params = _map(lambda a: np.asarray(a, np.float32), wm.params)
    dp = None if mesh is None else dp_group(mesh)

    def model_fn(p, batch):
        toks = batch["tokens"].long()
        inp = torch.clamp(toks[:, :-1], min=0)  # pad cells attend but don't score
        logits = teacher_forced_logits(p, batch["mel"], inp, hp, dtype=dtype,
                                       freeze_encoder=freeze_encoder)
        return masked_ce_loss(logits, toks[:, 1:], dp)

    trainable = (lambda path: "['enc']" not in path) if freeze_encoder else None
    return OptContext(model_fn, params, loss_type="sum", optimizer=optimizer,
                      opt_period=opt_period, get_opt_pars=get_opt_pars,
                      trainable=trainable, mesh=mesh, device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


class _DictBatcher:
    """Adapts dict batches to OptContext.step(): stacks mel/token arrays."""

    @staticmethod
    def collate(samples: Iterable[Tuple[np.ndarray, np.ndarray]],
                n_text: int) -> Dict[str, np.ndarray]:
        mels, toks = [], []
        for mel, t in samples:
            t = np.asarray(t, np.int32)
            row = np.full((n_text,), IGNORE_INDEX, np.int32)
            row[: len(t)] = t
            mels.append(np.asarray(mel, np.float32))
            toks.append(row)
        return {"mel": np.stack(mels), "tokens": np.stack(toks)}


def finetune(wm: WhisperModel,
             samples: Iterable[Tuple[np.ndarray, np.ndarray]],
             steps: int = 100,
             batch_size: int = 1,
             lr: float = 1e-5,
             optimizer: str = "adamw",
             freeze_encoder: bool = True,
             mesh=None,
             log=None,
             device=None) -> Tuple[Dict[str, Any], list]:
    """Overfit/adapt `wm` on (mel, tokens) pairs; returns (params, losses).

    Cycles the sample list for `steps` optimizer steps.  Token rows must
    already include the SOT prompt and EOT (use
    decoding.tokenizer helpers); rows are IGNORE_INDEX-padded to the
    longest row (+1 for the shift).  The parameters are tensors on
    `device` (the CUDA card unless "cpu").
    """
    samples = list(samples)
    if not samples:
        raise ValueError("no training samples")
    ctx = make_finetune_context(
        wm, optimizer=optimizer, freeze_encoder=freeze_encoder, mesh=mesh,
        get_opt_pars=lambda _it: OptimizerParams(alpha=lr), device=device)
    n_text = max(len(t) for _, t in samples)
    losses = []
    for it in range(steps):
        pick = [samples[(it * batch_size + j) % len(samples)]
                for j in range(batch_size)]
        batch = _DictBatcher.collate(pick, n_text)
        loss = ctx.step(batch)
        losses.append(loss)
        if log:
            log(f"step {it + 1}/{steps}: loss {loss:.4f}")
    return ctx.params, losses


# ---------------------------------------------------------------------------
# Saving: invert load.build_param_pytree back to reference tensor names
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return (a.detach().float().cpu().numpy() if torch.is_tensor(a)
            else np.asarray(a, np.float32))


def pytree_to_tensors(params: Dict[str, Any], hp: WhisperHParams
                      ) -> Dict[str, np.ndarray]:
    """Inverse of load.build_param_pytree: un-stack the layer axis, un-fuse
    the qkv concatenation (dropping the synthetic zero key bias — the file
    format stores no attn.key.bias, src/whisper.cpp graph adds none), and
    transpose 2-D weights back to the (out, in) torch-Linear layout the
    converter writes (models/convert-pt-to-ggml.py:305-317).  Leaves may be
    tensors (on any device) or arrays."""
    t: Dict[str, np.ndarray] = {}

    def put(name, arr, transpose=False):
        a = _np(arr)
        t[name] = a.T if transpose else a

    enc, dec = params["enc"], params["dec"]
    put("encoder.positional_embedding", enc["pos_embd"])
    # conv bias numpy shape (ns, 1) = ggml ne [1, ns], matching the loader's
    # whisper_model_load expectation and the converter's output
    put("encoder.conv1.weight", enc["conv1_w"])
    put("encoder.conv1.bias", _np(enc["conv1_b"]).reshape(-1, 1))
    put("encoder.conv2.weight", enc["conv2_w"])
    put("encoder.conv2.bias", _np(enc["conv2_b"]).reshape(-1, 1))
    put("encoder.ln_post.weight", enc["ln_post_w"])
    put("encoder.ln_post.bias", enc["ln_post_b"])

    def unfuse_blocks(blocks, n_layer, prefix, cross):
        n = blocks["o_w"].shape[-1]
        for i in range(n_layer):
            p = f"{prefix}.blocks.{i}."
            qkv_w = _np(blocks["qkv_w"][i])  # (in, 3*out)
            qkv_b = _np(blocks["qkv_b"][i])
            put(p + "attn.query.weight", qkv_w[:, :n], True)
            put(p + "attn.key.weight", qkv_w[:, n:2 * n], True)
            put(p + "attn.value.weight", qkv_w[:, 2 * n:], True)
            put(p + "attn.query.bias", qkv_b[:n])
            put(p + "attn.value.bias", qkv_b[2 * n:])
            put(p + "attn.out.weight", blocks["o_w"][i], True)
            put(p + "attn.out.bias", blocks["o_b"][i])
            put(p + "attn_ln.weight", blocks["attn_ln_w"][i])
            put(p + "attn_ln.bias", blocks["attn_ln_b"][i])
            if cross:
                put(p + "cross_attn_ln.weight", blocks["xattn_ln_w"][i])
                put(p + "cross_attn_ln.bias", blocks["xattn_ln_b"][i])
                put(p + "cross_attn.query.weight", blocks["xq_w"][i], True)
                put(p + "cross_attn.query.bias", blocks["xq_b"][i])
                put(p + "cross_attn.key.weight", blocks["xk_w"][i], True)
                put(p + "cross_attn.value.weight", blocks["xv_w"][i], True)
                put(p + "cross_attn.value.bias", blocks["xv_b"][i])
                put(p + "cross_attn.out.weight", blocks["xo_w"][i], True)
                put(p + "cross_attn.out.bias", blocks["xo_b"][i])
            put(p + "mlp_ln.weight", blocks["mlp_ln_w"][i])
            put(p + "mlp_ln.bias", blocks["mlp_ln_b"][i])
            put(p + "mlp.0.weight", blocks["mlp0_w"][i], True)
            put(p + "mlp.0.bias", blocks["mlp0_b"][i])
            put(p + "mlp.2.weight", blocks["mlp1_w"][i], True)
            put(p + "mlp.2.bias", blocks["mlp1_b"][i])

    unfuse_blocks(enc["blocks"], hp.n_audio_layer, "encoder", cross=False)
    put("decoder.positional_embedding", dec["pos_embd"])
    put("decoder.token_embedding.weight", dec["tok_embd"])
    put("decoder.ln.weight", dec["ln_w"])
    put("decoder.ln.bias", dec["ln_b"])
    unfuse_blocks(dec["blocks"], hp.n_text_layer, "decoder", cross=True)
    return t


def save_finetuned(path: str, wm: WhisperModel, params: Dict[str, Any],
                   use_f16: bool = True) -> None:
    """Write the fine-tuned parameters as a standard legacy-ggml file."""
    tensors = pytree_to_tensors(params, wm.hparams)
    # write the full vocab (file tokens + synthesized) — the loader then
    # reads every id directly and synthesizes nothing on reload
    tokens = [wm.vocab.id_to_token.get(i, b"") for i in range(wm.hparams.n_vocab)]
    write_model_file(path, wm.hparams, wm.filters, tokens, tensors,
                     use_f16=use_f16)
