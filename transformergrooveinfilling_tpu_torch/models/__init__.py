"""Model families: the encoder-only and the encoder-decoder groove transformer
with h/v/o heads."""

from .transformer import (
    GrooveTransformerConfig,
    GrooveTransformer,
    GrooveTransformerEncoder,
    sinusoidal_positional_encoding,
    build_model,
    init_parameters,
    predict,
)
from .losses import LossOutputs, calculate_loss
from . import torch_compat

__all__ = [
    "GrooveTransformerConfig",
    "GrooveTransformer",
    "GrooveTransformerEncoder",
    "sinusoidal_positional_encoding",
    "build_model",
    "init_parameters",
    "predict",
    "LossOutputs",
    "calculate_loss",
    "torch_compat",
]
