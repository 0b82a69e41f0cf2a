"""Training / fine-tuning support on torch autograd — the port of
whisper_tpu/training, the analogue of ggml-opt (reference
ggml/include/ggml-opt.h, ggml/src/ggml-opt.cpp)."""

from .opt import (  # noqa: F401
    LOSS_CROSS_ENTROPY,
    LOSS_MEAN,
    LOSS_MEAN_SQUARED_ERROR,
    LOSS_SUM,
    Dataset,
    OptContext,
    OptimizerParams,
    Result,
    default_optimizer_params,
    epoch,
    fit,
)
