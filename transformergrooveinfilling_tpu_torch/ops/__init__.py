"""Hand-written CUDA kernels' wrappers, each beside its plain PyTorch version,
and the MSO DSP and on-device drum synthesis built on them.

The band-energy kernel's wrappers are ``ops.band_energies.band_energies``
(frames) and ``ops.band_energies.band_energies_from_audio`` (waveforms): they
are not re-exported here, since the first shares its module's name.
"""

from . import band_energies, device_synth, mso
from .attention import fused_mha, mha_reference
from .device_synth import synth_events, synth_events_plain, synthesize_on_device
from .fused_decoder_layer import decoder_layer_reference, decoder_layer_train
from .fused_ffn import ffn_reference, ffn_train
from .fused_layer import encoder_layer_reference, encoder_layer_train
from .fused_ln import dropout_add_layernorm, dropout_add_layernorm_reference
from .mso import MSOParams, mso_batch, mso_batch_from_hvo, mso_from_audio

__all__ = ["fused_mha", "mha_reference", "encoder_layer_train", "encoder_layer_reference",
           "decoder_layer_train", "decoder_layer_reference", "ffn_train", "ffn_reference",
           "dropout_add_layernorm", "dropout_add_layernorm_reference",
           "synth_events", "synth_events_plain", "synthesize_on_device",
           "band_energies", "device_synth", "mso",
           "MSOParams", "mso_from_audio", "mso_batch", "mso_batch_from_hvo"]
