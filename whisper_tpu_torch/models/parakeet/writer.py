"""Write Parakeet-TDT ggml model files (converter + synthetic fixtures).

Mirror of models/convert-parakeet-to-ggml.py's output layout.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Optional

import numpy as np

from ...formats import container, quants
from .hparams import ParakeetHParams


def write_parakeet_model(path: str, hp: ParakeetHParams,
                         filters: np.ndarray, window: np.ndarray,
                         vocab_tokens: Iterable[bytes],
                         tensors: Dict[str, np.ndarray],
                         use_f16: bool = False) -> None:
    ftype = (quants.GGML_FTYPE_MOSTLY_F16 if use_f16
             else quants.GGML_FTYPE_ALL_F32)
    with open(path, "wb") as f:
        container.write_i32(f, container.GGML_FILE_MAGIC)
        for v in (hp.n_vocab, hp.n_audio_ctx, hp.n_audio_state,
                  hp.n_audio_head, hp.n_audio_layer, hp.n_mels,
                  ftype + quants.GGML_QNT_VERSION * quants.GGML_QNT_VERSION_FACTOR,
                  hp.n_fft, hp.subsampling_factor, hp.n_subsampling_channels,
                  hp.n_conv_kernel, hp.n_pred_dim, hp.n_pred_layers,
                  hp.n_tdt_durations, hp.n_max_tokens):
            container.write_i32(f, v)

        n_mel, n_fb = filters.shape
        container.write_i32(f, n_mel)
        container.write_i32(f, n_fb)
        f.write(np.ascontiguousarray(filters, "<f4").tobytes())

        container.write_i32(f, len(window))
        f.write(np.ascontiguousarray(window, "<f4").tobytes())

        f.write(struct.pack(f"<{hp.n_tdt_durations}I", *hp.tdt_durations))

        toks = list(vocab_tokens)
        container.write_i32(f, len(toks))
        for t in toks:
            container.write_i32(f, len(t))
            f.write(t)

        for name, arr in tensors.items():
            arr = np.asarray(arr, np.float32)
            # 2-D weight matrices may be f16; everything else stays f32.
            # depthwise_conv.weight is ALWAYS f32 — the reference creates it
            # GGML_TYPE_F32 regardless of ftype (src/parakeet.cpp:1327) and
            # its loader requires file types to match exactly
            st = (quants.GGML_TYPE_F16
                  if use_f16 and arr.ndim == 2 and "weight" in name
                  and "depthwise_conv" not in name
                  else quants.GGML_TYPE_F32)
            container.write_tensor_record(f, name, arr, st)


def synth_parakeet_tensors(hp: ParakeetHParams, seed: int = 0
                           ) -> Dict[str, np.ndarray]:
    """Deterministic random weights with the exact shapes of the reference
    loader (src/parakeet.cpp:1280-1402)."""
    rng = np.random.default_rng(seed)
    S, ch = hp.n_audio_state, hp.n_subsampling_channels
    D = hp.n_pred_dim

    def w(*shape, std=None):
        std = std if std is not None else 1.0 / np.sqrt(shape[-1])
        return (rng.standard_normal(shape) * std).astype(np.float32)

    n_pre_feat = (hp.n_mels // hp.subsampling_factor) * ch
    t = {
        "encoder.pre_encode.out.weight": w(S, n_pre_feat),
        "encoder.pre_encode.out.bias": w(S),
    }
    for i, (cin, cout, k) in [(0, (1, ch, 3)), (2, (1, ch, 3)),
                              (3, (ch, ch, 1)), (5, (1, ch, 3)),
                              (6, (ch, ch, 1))]:
        t[f"encoder.pre_encode.conv.{i}.weight"] = w(cout, cin, k, k, std=0.3)
        t[f"encoder.pre_encode.conv.{i}.bias"] = w(1, cout, 1, 1)

    for i in range(hp.n_audio_layer):
        p = f"encoder.layers.{i}."
        t[p + "norm_feed_forward1.weight"] = np.ones(S, np.float32)
        t[p + "norm_feed_forward1.bias"] = np.zeros(S, np.float32)
        t[p + "feed_forward1.linear1.weight"] = w(4 * S, S)
        t[p + "feed_forward1.linear2.weight"] = w(S, 4 * S)
        t[p + "norm_conv.weight"] = np.ones(S, np.float32)
        t[p + "norm_conv.bias"] = np.zeros(S, np.float32)
        t[p + "conv.pointwise_conv1.weight"] = w(2 * S, S)
        t[p + "conv.depthwise_conv.weight"] = w(S, hp.n_conv_kernel)
        t[p + "conv.batch_norm.weight"] = np.ones(S, np.float32)
        t[p + "conv.batch_norm.bias"] = np.zeros(S, np.float32)
        t[p + "conv.batch_norm.running_mean"] = np.zeros(S, np.float32)
        t[p + "conv.batch_norm.running_var"] = np.ones(S, np.float32)
        t[p + "conv.batch_norm.num_batches_tracked"] = np.ones(1, np.float32)
        t[p + "conv.pointwise_conv2.weight"] = w(S, S)
        t[p + "norm_self_att.weight"] = np.ones(S, np.float32)
        t[p + "norm_self_att.bias"] = np.zeros(S, np.float32)
        dh = S // hp.n_audio_head
        t[p + "self_attn.pos_bias_u"] = w(hp.n_audio_head, dh, std=0.1)
        t[p + "self_attn.pos_bias_v"] = w(hp.n_audio_head, dh, std=0.1)
        for nm in ("linear_q", "linear_k", "linear_v", "linear_out",
                   "linear_pos"):
            t[p + f"self_attn.{nm}.weight"] = w(S, S)
        t[p + "norm_feed_forward2.weight"] = np.ones(S, np.float32)
        t[p + "norm_feed_forward2.bias"] = np.zeros(S, np.float32)
        t[p + "feed_forward2.linear1.weight"] = w(4 * S, S)
        t[p + "feed_forward2.linear2.weight"] = w(S, 4 * S)
        t[p + "norm_out.weight"] = np.ones(S, np.float32)
        t[p + "norm_out.bias"] = np.zeros(S, np.float32)

    t["decoder.prediction.embed.weight"] = w(hp.n_vocab + 1, D, std=0.1)
    for i in range(hp.n_pred_layers):
        in_dim = D
        t[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{i}"] = w(4 * D, in_dim)
        t[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{i}"] = w(4 * D, D)
        t[f"decoder.prediction.dec_rnn.lstm.bias_h_l{i}"] = w(4 * D)
    t["joint.pred.weight"] = w(D, D)
    t["joint.pred.bias"] = w(D)
    t["joint.enc.weight"] = w(D, S)
    t["joint.enc.bias"] = w(D)
    t["joint.joint_net.2.weight"] = w(hp.n_joint_out, D)
    t["joint.joint_net.2.bias"] = w(hp.n_joint_out)
    return t
