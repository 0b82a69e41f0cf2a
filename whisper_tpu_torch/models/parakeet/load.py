"""Parakeet-TDT legacy ggml model loader.

File layout (reference: src/parakeet.cpp:1011-1210,
models/convert-parakeet-to-ggml.py): magic, 15 i32 hparams, mel filterbank,
analysis window, tdt_durations (u32), SentencePiece vocab, tensor records.
"""

from __future__ import annotations

import dataclasses
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, List, Optional

import numpy as np

from ...formats import container, quants
from .hparams import ParakeetHParams


@dataclass
class ParakeetVocab:
    """src/parakeet.cpp:1146-1210."""

    id_to_token: List[str]
    token_blank: int
    token_unk: int
    token_bos: int
    token_eos: int
    token_to_id: Dict[str, int] = field(default_factory=dict)
    max_token_length: int = 0

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.id_to_token)}
        self.max_token_length = max((len(t) for t in self.id_to_token),
                                    default=0)


@dataclass
class ParakeetModel:
    hparams: ParakeetHParams
    filters: np.ndarray    # (n_mel, n_fb) f32
    window: np.ndarray     # analysis window from training (f32)
    vocab: ParakeetVocab
    params: Dict[str, Any]
    wtype: int = quants.GGML_TYPE_F32
    # packed quant planes per file tensor name (quantized files only) —
    # the parakeet analogue of WhisperModel.qparams; feeds the packed
    # encoder-weight path (model.PQW / context use_packed_weights)
    qplanes: Optional[Dict[str, "quants.QTensor"]] = None

    @property
    def is_empty(self) -> bool:
        return not self.params


def _layer_name(base: str, i: int) -> str:
    return f"encoder.layers.{i}.{base}"


def build_param_pytree(tensors: Dict[str, np.ndarray],
                       hp: ParakeetHParams) -> Dict[str, Any]:
    """Stack per-layer tensors along a leading layer axis for lax.scan."""
    if not tensors:
        return {}

    def T(name: str) -> np.ndarray:
        return tensors[name]

    pre = {
        "out_w": T("encoder.pre_encode.out.weight"),
        "out_b": T("encoder.pre_encode.out.bias"),
    }
    for i in (0, 2, 3, 5, 6):
        pre[f"conv{i}_w"] = T(f"encoder.pre_encode.conv.{i}.weight")
        # bias stored as ggml [1,1,ch,1] -> numpy (1, ch, 1, 1)
        pre[f"conv{i}_b"] = T(f"encoder.pre_encode.conv.{i}.bias").reshape(-1)

    layer_keys = {
        "norm_ff1_w": "norm_feed_forward1.weight",
        "norm_ff1_b": "norm_feed_forward1.bias",
        "ff1_lin1_w": "feed_forward1.linear1.weight",
        "ff1_lin2_w": "feed_forward1.linear2.weight",
        "norm_conv_w": "norm_conv.weight",
        "norm_conv_b": "norm_conv.bias",
        "conv_pw1_w": "conv.pointwise_conv1.weight",
        "conv_dw_w": "conv.depthwise_conv.weight",
        "conv_bn_w": "conv.batch_norm.weight",
        "conv_bn_b": "conv.batch_norm.bias",
        "conv_bn_mean": "conv.batch_norm.running_mean",
        "conv_bn_var": "conv.batch_norm.running_var",
        "conv_pw2_w": "conv.pointwise_conv2.weight",
        "norm_attn_w": "norm_self_att.weight",
        "norm_attn_b": "norm_self_att.bias",
        "pos_bias_u": "self_attn.pos_bias_u",
        "pos_bias_v": "self_attn.pos_bias_v",
        "attn_q_w": "self_attn.linear_q.weight",
        "attn_k_w": "self_attn.linear_k.weight",
        "attn_v_w": "self_attn.linear_v.weight",
        "attn_out_w": "self_attn.linear_out.weight",
        "attn_pos_w": "self_attn.linear_pos.weight",
        "norm_ff2_w": "norm_feed_forward2.weight",
        "norm_ff2_b": "norm_feed_forward2.bias",
        "ff2_lin1_w": "feed_forward2.linear1.weight",
        "ff2_lin2_w": "feed_forward2.linear2.weight",
        "norm_out_w": "norm_out.weight",
        "norm_out_b": "norm_out.bias",
    }
    layers = {
        k: np.stack([T(_layer_name(v, i)) for i in range(hp.n_audio_layer)])
        for k, v in layer_keys.items()
    }

    pred = {
        "embed_w": T("decoder.prediction.embed.weight"),
        "lstm_ih_w": np.stack([
            T(f"decoder.prediction.dec_rnn.lstm.weight_ih_l{i}")
            for i in range(hp.n_pred_layers)]),
        "lstm_hh_w": np.stack([
            T(f"decoder.prediction.dec_rnn.lstm.weight_hh_l{i}")
            for i in range(hp.n_pred_layers)]),
        "lstm_b_h": np.stack([
            T(f"decoder.prediction.dec_rnn.lstm.bias_h_l{i}")
            for i in range(hp.n_pred_layers)]),
    }
    joint = {
        "pred_w": T("joint.pred.weight"),
        "pred_b": T("joint.pred.bias"),
        "enc_w": T("joint.enc.weight"),
        "enc_b": T("joint.enc.bias"),
        "net_w": T("joint.joint_net.2.weight"),
        "net_b": T("joint.joint_net.2.bias"),
    }
    return {"pre": pre, "layers": layers, "pred": pred, "joint": joint}


def load_parakeet_model(path: str, dtype: Any = np.float32) -> ParakeetModel:
    with open(path, "rb") as f:
        container.check_magic(f)
        hp = ParakeetHParams(
            n_vocab=container.read_i32(f),
            n_audio_ctx=container.read_i32(f),
            n_audio_state=container.read_i32(f),
            n_audio_head=container.read_i32(f),
            n_audio_layer=container.read_i32(f),
            n_mels=container.read_i32(f),
            ftype=container.read_i32(f),
            n_fft=container.read_i32(f),
            subsampling_factor=container.read_i32(f),
            n_subsampling_channels=container.read_i32(f),
            n_conv_kernel=container.read_i32(f),
            n_pred_dim=container.read_i32(f),
            n_pred_layers=container.read_i32(f),
            n_tdt_durations=container.read_i32(f),
            n_max_tokens=container.read_i32(f),
        )
        ftype = hp.ftype % quants.GGML_QNT_VERSION_FACTOR
        wtype = quants.FTYPE_TO_QTYPE.get(ftype, quants.GGML_TYPE_F16)

        # parakeet_validate_hparams (src/parakeet.cpp:693-714): every hparam
        # must be > 0 and <= the standard model value (guards corrupt files,
        # e.g. for-tests-ggml-parakeet-tdt-bad-nfft0.bin)
        std = ParakeetHParams()
        for name in ("n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
                     "n_audio_layer", "n_mels", "n_fft", "subsampling_factor",
                     "n_subsampling_channels", "n_conv_kernel", "n_pred_dim",
                     "n_pred_layers", "n_tdt_durations", "n_max_tokens"):
            actual, expected = getattr(hp, name), getattr(std, name)
            if actual <= 0 or actual > expected:
                raise ValueError(
                    f"invalid Parakeet metadata: {name} = {actual}, "
                    f"expected > 0 and <= {expected}")

        n_mel = container.read_i32(f)
        n_fb = container.read_i32(f)
        filters = np.frombuffer(f.read(4 * n_mel * n_fb),
                                dtype="<f4").reshape(n_mel, n_fb).copy()

        n_window = container.read_i32(f)
        window = np.frombuffer(f.read(4 * n_window), dtype="<f4").copy()

        tdt = struct.unpack(f"<{hp.n_tdt_durations}I",
                            f.read(4 * hp.n_tdt_durations))
        hp = dataclasses.replace(hp, tdt_durations=tuple(int(d) for d in tdt))

        n_vocab = container.read_i32(f)
        id_to_token: List[str] = []
        for _ in range(n_vocab):
            n = container.read_u32(f)
            id_to_token.append(f.read(n).decode("utf-8", errors="replace"))
        blank_id = n_vocab
        tok2id = {t: i for i, t in enumerate(id_to_token)}
        vocab = ParakeetVocab(
            id_to_token=id_to_token + ["[BLANK]"],
            token_blank=blank_id,
            token_unk=tok2id.get("<unk>", 0),
            token_bos=tok2id.get("<s>", tok2id.get("<|startoftranscript|>", 0)),
            token_eos=tok2id.get("</s>", tok2id.get("<|endoftext|>", 0)),
        )

        tensors: Dict[str, np.ndarray] = {}
        qplanes: Dict[str, quants.QTensor] = {}
        for r in container.read_tensor_records(f):
            tensors[r.name] = r.to_f32().astype(dtype)
            if r.ggml_type not in (quants.GGML_TYPE_F32,
                                   quants.GGML_TYPE_F16):
                try:
                    qplanes[r.name] = r.to_planes()
                except NotImplementedError:
                    pass

    params = build_param_pytree(tensors, hp) if tensors else {}
    return ParakeetModel(hp, filters, window, vocab, params, wtype,
                         qplanes or None)


# encoder weights eligible for the packed path, pytree key -> file suffix.
# The prediction/joint/LSTM weights stay DENSE by design: they run INSIDE
# the on-device TDT while_loop where a per-iteration dequant would repeat
# every emitted token, and they are small (~10 MB) so their HBM cost is
# negligible; the conformer stack is where quantized storage pays.
PACKED_LAYER_KEYS = {
    "ff1_lin1_w": "feed_forward1.linear1.weight",
    "ff1_lin2_w": "feed_forward1.linear2.weight",
    "conv_pw1_w": "conv.pointwise_conv1.weight",
    "conv_pw2_w": "conv.pointwise_conv2.weight",
    "attn_q_w": "self_attn.linear_q.weight",
    "attn_k_w": "self_attn.linear_k.weight",
    "attn_v_w": "self_attn.linear_v.weight",
    "attn_out_w": "self_attn.linear_out.weight",
    "attn_pos_w": "self_attn.linear_pos.weight",
    "ff2_lin1_w": "feed_forward2.linear1.weight",
    "ff2_lin2_w": "feed_forward2.linear2.weight",
}


def build_packed_overlay(qplanes: Dict[str, "quants.QTensor"],
                         hp: ParakeetHParams) -> Dict[str, Any]:
    """Stacked packed planes {layer_key: (codes, scales, mins|None)} for
    every conformer weight whose planes exist in the file (+ the
    pre-encode output linear under key "pre.out_w").  Affine formats
    (K-quants) keep their mins plane — model._pmm dequantizes
    codes*scale(+min) fused into the matmul."""
    out: Dict[str, Any] = {}
    for key, suffix in PACKED_LAYER_KEYS.items():
        names = [_layer_name(suffix, i) for i in range(hp.n_audio_layer)]
        if all(n in qplanes for n in names):
            qs = [qplanes[n] for n in names]
            affine = qs[0].mins is not None
            out[key] = (np.stack([q.codes for q in qs]),
                        np.stack([q.scales for q in qs]),
                        np.stack([q.mins for q in qs]) if affine else None)
    po = qplanes.get("encoder.pre_encode.out.weight")
    if po is not None:
        out["pre.out_w"] = (po.codes, po.scales, po.mins)
    return out
