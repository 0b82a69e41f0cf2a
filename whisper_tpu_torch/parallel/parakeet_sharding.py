"""The Parakeet-TDT tensor-parallel spec table, as data, and
`shard_parakeet_params`.

Port of whisper_tpu/parallel/parakeet_sharding.py: the Whisper table's
recipe (parallel/sharding.py) on the conformer.  Per-layer weights are
(L, out, in), the file orientation, so a column-parallel leaf (the JAX
`P(None, "tp", None)`) shards dimension 1 and a row-parallel one
(`P(None, None, "tp")`) dimension 2.

  * attention q/k/v/pos: column (heads); out: row, all-reduced after
    (models/parakeet/model.py `tp=`); pos_bias_u/v (L, H, d): heads;
  * both feed-forward halves: linear1 column, linear2 row;
  * the conv module stays replicated, pointwise_conv2 included (the JAX
    table's `rep3`, though its module docstring calls pw2 row-sharded):
    pointwise_conv1 packs the GLU's signal and gate in one output
    dimension, so a column shard would split them;
  * the pre-encode stem, the prediction LSTM and the joint: replicated.

Packed `PQW` planes raise, as the Whisper table's packed planes do.
"""

from __future__ import annotations

from typing import Any, Dict

from .mesh import axis_group, group_rank, group_size
from .sharding import shard_tree

COL, ROW, REP = 1, 2, None


def parakeet_param_specs() -> Dict[str, Any]:
    """The spec of every leaf of models/parakeet/load.py's tree."""
    layers = {
        "norm_ff1_w": REP, "norm_ff1_b": REP,
        "ff1_lin1_w": COL, "ff1_lin2_w": ROW,
        "norm_conv_w": REP, "norm_conv_b": REP,
        "conv_pw1_w": REP,          # GLU signal|gate packed: replicated
        "conv_dw_w": REP,
        "conv_bn_w": REP, "conv_bn_b": REP,
        "conv_bn_mean": REP, "conv_bn_var": REP,
        "conv_pw2_w": REP,
        "norm_attn_w": REP, "norm_attn_b": REP,
        "pos_bias_u": 1,
        "pos_bias_v": 1,
        "attn_q_w": COL, "attn_k_w": COL, "attn_v_w": COL,
        "attn_pos_w": COL,
        "attn_out_w": ROW,
        "norm_ff2_w": REP, "norm_ff2_b": REP,
        "ff2_lin1_w": COL, "ff2_lin2_w": ROW,
        "norm_out_w": REP, "norm_out_b": REP,
    }
    pre = {
        "out_w": REP, "out_b": REP,
        **{f"conv{i}_w": REP for i in (0, 2, 3, 5, 6)},
        **{f"conv{i}_b": REP for i in (0, 2, 3, 5, 6)},
    }
    pred = {
        "embed_w": REP,
        "lstm_ih_w": REP, "lstm_hh_w": REP, "lstm_b_h": REP,
    }
    joint = {
        "pred_w": REP, "pred_b": REP,
        "enc_w": REP, "enc_b": REP,
        "net_w": REP, "net_b": REP,
    }
    return {"pre": pre, "layers": layers, "pred": pred, "joint": joint}


def shard_parakeet_params(params, mesh):
    """This rank's local tensors of a dense Parakeet tree."""
    group = axis_group(mesh, "tp")
    return shard_tree(params, parakeet_param_specs(), group_size(group),
                      group_rank(group), {})
