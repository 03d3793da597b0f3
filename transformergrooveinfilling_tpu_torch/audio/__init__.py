"""Host-side audio synthesis: the procedural drum kit and the numpy mixer.

The reference the on-device synthesizer (``ops/device_synth.py``) is held to.
16-bit WAV files written through the standard library. SoundFont kits, the
C++ mixer and reading WAV files are not ported yet.
"""

from .synth import synthesize_hvo, synthesize_hvo_batch, write_wav

__all__ = ["synthesize_hvo", "synthesize_hvo_batch", "write_wav"]
