"""Host-side audio synthesis: the procedural drum kit and the numpy mixer.

The reference the on-device synthesizer (``ops/device_synth.py``) is held to.
SoundFont kits, the C++ mixer and WAV I/O are not ported yet.
"""

from .synth import synthesize_hvo, synthesize_hvo_batch

__all__ = ["synthesize_hvo", "synthesize_hvo_batch"]
