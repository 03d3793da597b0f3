"""Deterministic synthetic GMD-style loops, as the JAX package's
``data/synthetic.py``: the same seeded generator, draw for draw, so a corpus
from a seed is the same in either package.

The Groove MIDI Dataset pickles are not in the repository, so tests,
``process_dataset`` and the smoke script need a corpus of the same shape:
style-tagged 2-bar HVO loops (kick/snare backbeat, a per-style hat grid,
sparse toms and cymbals, humanized velocity and offset), tagged with the
metadata fields the subsetter filters on.
"""

from __future__ import annotations

import numpy as np

from ..hvo import HVOSequence, N_VOICES
from ..hvo.sequence import Metadata, Tempo, TimeSignature

STYLES = (
    "hiphop", "funk", "reggae", "soul", "latin", "jazz",
    "pop", "afrobeat", "highlife", "punk", "rock",
)

# per-style (kick_prob_on_beat, snare_backbeat_prob, hat_density, extra_density)
_STYLE_PROFILES = {
    "hiphop": (0.9, 0.9, 0.8, 0.05),
    "funk": (0.7, 0.8, 0.9, 0.15),
    "reggae": (0.5, 0.7, 0.7, 0.10),
    "soul": (0.8, 0.9, 0.8, 0.10),
    "latin": (0.6, 0.5, 0.6, 0.30),
    "jazz": (0.4, 0.4, 0.5, 0.25),
    "pop": (0.9, 0.95, 0.85, 0.05),
    "afrobeat": (0.6, 0.6, 0.7, 0.25),
    "highlife": (0.6, 0.6, 0.7, 0.20),
    "punk": (0.95, 0.95, 0.95, 0.10),
    "rock": (0.9, 0.95, 0.9, 0.10),
}


# one bar (16 steps) of closed-hat placement per style — the style signature
# carried by the kept voices makes these recoverable
_STYLE_HAT_PATTERNS = {
    "hiphop":   [1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0],  # 8ths
    "funk":     [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],  # 16ths
    "reggae":   [0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0],  # off-beats
    "soul":     [1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1],
    "latin":    [1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0, 0, 1, 0],  # tresillo
    "jazz":     [0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0],
    "pop":      [1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0],
    "afrobeat": [1, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0],
    "highlife": [1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1],
    "punk":     [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    "rock":     [1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0],
}


def _pattern(rng: np.random.Generator, style: str, t: int = 32) -> np.ndarray:
    kick_p, snare_p, hat_d, extra_d = _STYLE_PROFILES[style]
    h = np.zeros((t, N_VOICES))
    # kick on beats (every 8 steps = quarter notes), plus syncopation
    for step in range(0, t, 8):
        if rng.random() < kick_p:
            h[step, 0] = 1
    h[:, 0] += (rng.random(t) < extra_d * 0.5) * (h[:, 0] == 0)
    # snare backbeat (steps 8, 24 within each bar of 16)
    for step in (8, 24):
        if rng.random() < snare_p:
            h[step % t, 1] = 1
    h[:, 1] += (rng.random(t) < extra_d * 0.3) * (h[:, 1] == 0)
    # closed hats: per-style deterministic pattern (so the infilling task is
    # learnable — the removed voice must be predictable from the kept ones;
    # a purely random hat grid has no mutual information with the context)
    hat_pattern = _STYLE_HAT_PATTERNS[style]
    for step in range(t):
        if hat_pattern[step % 16] and rng.random() < 0.92:  # light humanization
            h[step, 2] = 1
    # open hat occasionally replaces closed
    open_mask = (rng.random(t) < extra_d * 0.3) & (h[:, 2] > 0)
    h[open_mask, 3] = 1
    h[open_mask, 2] = 0
    # toms / crash / ride sparse
    for voice in (4, 5, 6, 7, 8):
        h[:, voice] = rng.random(t) < extra_d * 0.25
    h = np.clip(h, 0, 1)
    v = np.where(h > 0, rng.uniform(0.4, 1.0, h.shape), 0.0)
    o = np.where(h > 0, rng.uniform(-0.25, 0.25, h.shape), 0.0)
    return np.concatenate([h, v, o], axis=1)


def synthetic_gmd_sequences(
    n: int = 64,
    seed: int = 0,
    t: int = 32,
    styles=STYLES,
    beat_type: str = "beat",
) -> list:
    """Generate ``n`` style-tagged :class:`HVOSequence` fixtures."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        style = styles[i % len(styles)]
        qpm = float(rng.integers(70, 160))
        seq = HVOSequence(
            hvo=_pattern(rng, style, t),
            time_signatures=[TimeSignature()],
            tempos=[Tempo(qpm=qpm)],
            metadata=Metadata(
                drummer=f"drummer{i % 10}",
                session=f"session{i % 3 + 1}",
                master_id=f"drummer{i % 10}/session{i % 3 + 1}/{i}",
                style_primary=style,
                beat_type=beat_type,
                loop_id=f"loop_{i}",
                bpm=qpm,
            ),
        )
        if seq.is_silent():  # ensure usable fixtures
            seq.hvo[0, 0] = 1.0
            seq.hvo[0, N_VOICES] = 0.8
        out.append(seq)
    return out
