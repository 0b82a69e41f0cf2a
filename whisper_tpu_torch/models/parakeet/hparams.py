"""Parakeet-TDT hyperparameters (reference: src/parakeet.cpp:277-296,
src/parakeet-arch.h:219-239)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

SAMPLE_RATE = 16000   # PARAKEET_SAMPLE_RATE (include/parakeet.h:33)
HOP_LENGTH = 160      # PARAKEET_HOP_LENGTH  (include/parakeet.h:34)

# windowed local attention for long audio (src/parakeet.cpp:138-141)
LOCAL_ATTN_THRESHOLD = 8192
LOCAL_ATTN_WINDOW = 128


@dataclass(frozen=True)
class ParakeetHParams:
    """Frozen (hashable) so jitted functions can take it as a static arg."""

    n_vocab: int = 8192
    n_audio_ctx: int = 5000
    n_audio_state: int = 1024
    n_audio_head: int = 8
    n_audio_layer: int = 24
    n_mels: int = 128
    ftype: int = 1
    n_fft: int = 512
    eps: float = 1e-5
    subsampling_factor: int = 8
    n_subsampling_channels: int = 256
    n_conv_kernel: int = 9
    n_pred_dim: int = 640
    n_pred_layers: int = 2
    n_tdt_durations: int = 5
    n_max_tokens: int = 10
    tdt_durations: Tuple[int, ...] = (0, 1, 2, 3, 4)

    @property
    def blank_id(self) -> int:
        """Blank token sits at index n_vocab, outside the vocabulary
        (src/parakeet.cpp:1170-1173)."""
        return self.n_vocab

    @property
    def n_joint_out(self) -> int:
        return self.n_vocab + 1 + self.n_tdt_durations
