"""The Whisper tensor-parallel spec table, as data, and `shard_params`.

Port of whisper_tpu/parallel/sharding.py (the TPU analogue of the
reference meta backend's per-tensor split states,
ggml/include/ggml-backend.h:360-407).  Megatron-style TP over the mesh's
'tp' axis, leaf for leaf the JAX table:

  * attention q/k/v and the MLP's up projection: the output (head, hidden)
    dimension sharded, column parallel; the attention then runs on the
    rank's own heads;
  * attention out, cross-attention out and the MLP's down projection: the
    input dimension sharded, row parallel; the model functions all-reduce
    the partial products (models/whisper/model.py `tp=`), where the JAX
    package's GSPMD inserts its psum, and add the replicated bias after;
  * layer norms, the conv stem, positional and token embeddings:
    replicated (every rank computes the full logits, no collective);
  * caches and cross-K/V: sharded over their head dimension.

A spec is the dimension a leaf shards over 'tp', or None for a replicated
leaf.  Weights are (L, in, out), so the JAX `P(None, None, "tp")` (column)
is 2 and `P(None, "tp", None)` (row) is 1.

The fused QKV is the one leaf where a plain slice is wrong: its output
dimension is [q | k | v], so a contiguous column slice would hand rank 0
all of q and part of k.  GSPMD repairs that with collective-permutes; rank
code cannot, so `shard_params` slices each of q, k and v by heads: rank r
takes heads r*H/tp .. (r+1)*H/tp - 1 of q, of k and of v, in that order
(the reference meta backend's segmented split).  The same holds for the
fused bias.

The table covers the dense parameter tree only, as in the JAX package
(its packed install deletes the dense leaves): packed planes raise.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .mesh import axis_group, group_rank, group_size, take

COL, ROW, BIAS_SH, REP = 2, 1, 1, None

# fused [q | k | v] leaves: split by heads inside each third
FUSED_QKV = ("qkv_w", "qkv_b")


def param_specs(hp) -> Dict[str, Any]:
    """The spec of every leaf of the models/whisper/load.py parameter tree
    (whisper_tpu/parallel/sharding.py param_specs)."""
    enc_blocks = {
        "attn_ln_w": REP, "attn_ln_b": REP,
        "qkv_w": COL, "qkv_b": BIAS_SH,
        "o_w": ROW, "o_b": REP,
        "mlp_ln_w": REP, "mlp_ln_b": REP,
        "mlp0_w": COL, "mlp0_b": BIAS_SH,
        "mlp1_w": ROW, "mlp1_b": REP,
    }
    dec_blocks = dict(enc_blocks)
    dec_blocks.update({
        "xattn_ln_w": REP, "xattn_ln_b": REP,
        "xq_w": COL, "xq_b": BIAS_SH,
        "xk_w": COL,
        "xv_w": COL, "xv_b": BIAS_SH,
        "xo_w": ROW, "xo_b": REP,
    })
    return {
        "enc": {
            "pos_embd": REP,
            "conv1_w": REP, "conv1_b": REP,
            "conv2_w": REP, "conv2_b": REP,
            "ln_post_w": REP, "ln_post_b": REP,
            "blocks": enc_blocks,
        },
        "dec": {
            "pos_embd": REP,
            "tok_embd": REP,
            "ln_w": REP, "ln_b": REP,
            "blocks": dec_blocks,
        },
    }


def cross_kv_spec() -> int:
    """(n_layer, n_head, n_audio_ctx, d_head): heads."""
    return 1


def kv_cache_spec() -> int:
    """(n_layer, n_beam, n_head, 2, n_text_ctx, d_head): heads."""
    return 2


def dense_only_error(what: str) -> ValueError:
    return ValueError(
        f"tensor parallelism takes the dense parameter tree only, and {what} is "
        "packed: the spec table (as the JAX package's) covers the dense "
        "leaves, whose packed install drops them; load with "
        "use_packed_weights=False")


def split_heads_fused(x: torch.Tensor, dim: int, n_head: int, n: int, r: int) -> torch.Tensor:
    """Rank r of n's heads of a fused [q | k | v] dimension `dim` (3 * H
    heads wide), q's, k's and v's in that order, as a contiguous copy."""
    if n_head % n:
        raise ValueError(f"{n_head} heads do not split over tp={n}")
    k = n_head // n
    return x.unflatten(dim, (3, n_head, -1)).narrow(dim + 1, r * k, k).flatten(
        dim, dim + 2).contiguous()


def shard_tree(params, specs, n: int, r: int, n_heads: Dict[str, int],
               path: str = "") -> Any:
    """`params` with each leaf cut to rank r of n under `specs`; n_heads
    maps a top-level part ("enc", "dec") to the head count of its fused
    QKV leaves."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            name = f"{path}.{k}" if path else k
            if k not in specs:
                if k in ("blocks_packed", "tok_embd_t"):
                    raise dense_only_error(name)
                raise KeyError(f"no tensor-parallel spec for {name}")
            out[k] = shard_tree(v, specs[k], n, r, n_heads, name)
        return out
    if not torch.is_tensor(params):
        raise dense_only_error(f"{path} ({type(params).__name__})")
    if specs is None:
        return params
    if path.rsplit(".", 1)[-1] in FUSED_QKV:
        return split_heads_fused(params, specs, n_heads[path.split(".", 1)[0]], n, r)
    return take(params, specs, n, r, path)


def shard_params(params, mesh, hp):
    """This rank's local tensors of a dense parameter tree under the spec
    table (the JAX `shard_params` places the leaves; here each rank keeps
    its own part)."""
    group = axis_group(mesh, "tp")
    return shard_tree(params, param_specs(hp), group_size(group), group_rank(group),
                      {"enc": hp.n_audio_head, "dec": hp.n_text_head})
