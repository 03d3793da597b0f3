"""Drum-voice mappings.

``ROLAND_REDUCED_MAPPING`` is the 9-voice reduction of the Roland TD-11 kit used by
the Groove MIDI Dataset (Gillick et al. 2019, "Learning to Groove"). The
MIDI-note groupings below are the GMD-published reduction (public dataset
documentation), re-stated here — voice order defines HVO channel order. A copy
of the JAX package's ``hvo/mapping.py``: the port imports nothing of that package.
"""

from __future__ import annotations

# Ordered: voice index i -> (name, list of raw MIDI notes folding into it).
ROLAND_REDUCED_MAPPING = {
    "KICK": [36],
    "SNARE": [38, 37, 40],
    "HH_CLOSED": [42, 22, 44],
    "HH_OPEN": [46, 26],
    "TOM_3_LO": [43, 58],
    "TOM_2_MID": [47, 45],
    "TOM_1_HI": [50, 48],
    "CRASH": [49, 52, 55, 57],
    "RIDE": [51, 53, 59],
}

VOICE_NAMES = tuple(ROLAND_REDUCED_MAPPING.keys())
N_VOICES = len(ROLAND_REDUCED_MAPPING)

# Representative General-MIDI percussion note per voice, used when synthesizing or
# exporting back to MIDI (first note of each group).
VOICE_TO_MIDI_NOTE = tuple(notes[0] for notes in ROLAND_REDUCED_MAPPING.values())

_NOTE_TO_VOICE = {
    note: i for i, notes in enumerate(ROLAND_REDUCED_MAPPING.values()) for note in notes
}


def midi_note_to_voice(note: int) -> int | None:
    """Map a raw MIDI percussion note to its reduced voice index (None if unmapped)."""
    return _NOTE_TO_VOICE.get(note)
