"""Hand-written CUDA kernels' wrappers, each beside its plain PyTorch version."""

from .attention import fused_mha, mha_reference
from .fused_layer import encoder_layer_reference, encoder_layer_train

__all__ = ["fused_mha", "mha_reference", "encoder_layer_train", "encoder_layer_reference"]
