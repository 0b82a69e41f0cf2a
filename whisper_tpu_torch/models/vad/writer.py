"""Write silero-vad ggml model files.

Mirror of models/convert-silero-vad-to-ggml.py:32-185 — used by the synthetic
test-fixture generator and the torch converter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ...formats import container, quants
from .silero import (ENC_B, ENC_W, FINAL_B, FINAL_W, LSTM_B_HH, LSTM_B_IH,
                     LSTM_W_HH, LSTM_W_IH, STFT_BASIS, VadHParams)

# conv weights stored f16, everything else f32 (convert-silero-vad-to-ggml.py:79+,
# loader dtypes src/whisper.cpp:4896-4990)
_F16_TENSORS = {STFT_BASIS, *ENC_W, FINAL_W}


def write_vad_model(path: str, tensors: Dict[str, np.ndarray],
                    hp: VadHParams = None,
                    model_type: str = "silero-16k",
                    version=(6, 2, 0),
                    n_window: int = 512, n_context: int = 64) -> None:
    hp = hp or VadHParams()
    with open(path, "wb") as f:
        container.write_i32(f, container.GGML_FILE_MAGIC)
        mt = model_type.encode("utf-8")
        container.write_i32(f, len(mt))
        f.write(mt)
        for v in version:
            container.write_i32(f, v)
        container.write_i32(f, n_window)
        container.write_i32(f, n_context)
        container.write_i32(f, hp.n_encoder_layers)
        for i in range(hp.n_encoder_layers):
            container.write_i32(f, hp.encoder_in_channels[i])
            container.write_i32(f, hp.encoder_out_channels[i])
            container.write_i32(f, hp.kernel_sizes[i])
        container.write_i32(f, hp.lstm_input_size)
        container.write_i32(f, hp.lstm_hidden_size)
        container.write_i32(f, hp.final_conv_in)
        container.write_i32(f, hp.final_conv_out)
        for name, arr in tensors.items():
            st = (quants.GGML_TYPE_F16 if name in _F16_TENSORS
                  else quants.GGML_TYPE_F32)
            container.write_tensor_record(f, name, np.asarray(arr, np.float32), st)


def synth_vad_tensors(hp: VadHParams = None, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random weights at real silero dims (test fixture)."""
    hp = hp or VadHParams()
    rng = np.random.default_rng(seed)

    def w(*shape, std=0.1):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    t = {STFT_BASIS: w(258, 1, 256)}
    for i in range(hp.n_encoder_layers):
        t[ENC_W[i]] = w(hp.encoder_out_channels[i], hp.encoder_in_channels[i],
                        hp.kernel_sizes[i])
        t[ENC_B[i]] = w(hp.encoder_out_channels[i])
    h = hp.lstm_hidden_size
    t[LSTM_W_IH] = w(4 * h, hp.lstm_input_size)
    t[LSTM_B_IH] = w(4 * h)
    t[LSTM_W_HH] = w(4 * h, h)
    t[LSTM_B_HH] = w(4 * h)
    t[FINAL_W] = w(hp.final_conv_out, hp.final_conv_in)
    t[FINAL_B] = w(hp.final_conv_out)
    return t
