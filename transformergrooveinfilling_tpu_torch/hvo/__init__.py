"""HVO (hits / velocities / offsets) grids.

A drum loop is a ``(T, 3*V)`` float matrix with ``T = 32`` 16th-note steps and
``V = 9`` drum voices. Columns ``[0:V]`` are binary hits, ``[V:2V]`` velocities
in [0, 1], ``[2V:3V]`` timing offsets in fractional-gridstep units
(≈ [-0.5, 0.5]). ``HVOSequence`` and its metadata are not ported yet.
"""

from . import ops
from .mapping import N_VOICES, ROLAND_REDUCED_MAPPING, VOICE_NAMES, midi_note_to_voice

__all__ = ["ROLAND_REDUCED_MAPPING", "N_VOICES", "VOICE_NAMES", "midi_note_to_voice", "ops"]
