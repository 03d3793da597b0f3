"""Host-side audio synthesis: the procedural drum kit, SoundFont (.sf2)
kits (``sf2``), the C++ mixer (``native_binding``, built with g++ at first
use) and its numpy counterpart, and 16-bit WAV files.

The reference the on-device synthesizer (``ops/device_synth.py``) is held to.
"""

from .synth import read_wav, synthesize_hvo, synthesize_hvo_batch, write_wav

__all__ = ["synthesize_hvo", "synthesize_hvo_batch", "write_wav", "read_wav"]
