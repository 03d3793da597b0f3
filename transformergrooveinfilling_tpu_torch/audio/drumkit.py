"""Procedural drum-kit sample table (a numpy-only copy of the JAX package's
``audio/drumkit.py``; seeded generators and f64 maths with one cast at the end,
so both packages build the same samples bit for bit).

Deterministic, asset-free percussion samples (one per HVO voice) built from
classic synthesis recipes — pitch-swept sine kick, noise+tone snare, filtered
noise hats/cymbals, tuned decaying-sine toms. These stand in for a SoundFont when
none is given (the default kit makes the audio pipeline hermetic for tests and
measurements).
"""

from __future__ import annotations

import functools

import numpy as np

from ..hvo.mapping import N_VOICES


class DrumKit(tuple):
    """Velocity-layered sample table.

    Behaves as the legacy per-voice tuple (``kit[v]`` = the voice's
    velocity-127 render) so single-layer consumers keep working, and carries
    the full SF2 zone structure for velocity-aware synthesis:

    - ``samples``: flat list of rendered zone-group samples (one entry per
      distinct set of simultaneously-sounding zones — SF2 zones that overlap
      in velocity *stack*, so a group's sample is the sum of its zones).
    - ``lut``: ``(n_voices, 128)`` int32 — MIDI velocity → index into
      ``samples`` for each voice.

    Built from a SoundFont (``audio/sf2.py::kit_from_sf2``); plain tuples
    (the procedural kit) are adapted on the fly by :func:`kit_layers`.
    """

    def __new__(cls, per_voice, samples, lut):
        self = super().__new__(cls, per_voice)
        self.samples = list(samples)
        self.lut = np.asarray(lut, np.int32)
        return self


def kit_layers(table):
    """``(flat_samples, lut)`` view of any kit.

    ``table`` is either a :class:`DrumKit` or a plain per-voice sequence;
    the latter maps every velocity to the voice's single sample."""
    if isinstance(table, DrumKit):
        return table.samples, table.lut
    samples = list(table)
    lut = np.repeat(np.arange(len(samples), dtype=np.int32)[:, None], 128, 1)
    return samples, lut


def _env(n: int, sr: int, decay_s: float, attack_s: float = 0.002) -> np.ndarray:
    t = np.arange(n) / sr
    env = np.exp(-t / decay_s)
    a = max(int(attack_s * sr), 1)
    env[:a] *= np.linspace(0, 1, a)
    return env


def _noise(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n)


def _highpass(x: np.ndarray, sr: int, fc: float) -> np.ndarray:
    # one-pole highpass (y[i] = a*(y[i-1] + x[i] - x[i-1])), enough to shape
    # noise into hats/cymbals. Plain recurrence in f64: kit samples are built
    # once and cached, and the JAX package's kit has exactly these bits.
    rc = 1.0 / (2 * np.pi * fc)
    dt = 1.0 / sr
    alpha = rc / (rc + dt)
    d = alpha * np.diff(x, prepend=0.0)
    y = np.empty_like(d)
    acc = 0.0
    for i in range(len(d)):
        acc = alpha * acc + d[i]
        y[i] = acc
    return y


def _kick(sr: int) -> np.ndarray:
    # tight kick: fast 160→50 Hz sweep (~30 ms), short body so the low-band
    # energy stays at the onset instead of smearing into later grid steps
    n = int(0.22 * sr)
    t = np.arange(n) / sr
    freq = 160 * np.exp(-t / 0.03) + 50
    phase = 2 * np.pi * np.cumsum(freq) / sr
    body = np.sin(phase) * _env(n, sr, 0.09)
    click = _noise(int(0.005 * sr), 1) * 0.4
    body[: len(click)] += click * _env(len(click), sr, 0.004)
    return body


def _snare(sr: int) -> np.ndarray:
    n = int(0.25 * sr)
    t = np.arange(n) / sr
    tone = 0.5 * np.sin(2 * np.pi * 190 * t) + 0.3 * np.sin(2 * np.pi * 330 * t)
    rattle = _highpass(_noise(n, 2), sr, 1200)
    return (tone * _env(n, sr, 0.06) + 0.9 * rattle * _env(n, sr, 0.09))


def _hat(sr: int, open_: bool) -> np.ndarray:
    dur = 0.45 if open_ else 0.08
    n = int(dur * sr)
    metallic = sum(
        np.sign(np.sin(2 * np.pi * f * np.arange(n) / sr))
        for f in (3111.0, 4160.0, 5511.0, 6422.0)
    )
    x = 0.4 * metallic / 4 + 0.8 * _noise(n, 3 if open_ else 4)
    return _highpass(x, sr, 6000) * _env(n, sr, 0.18 if open_ else 0.025)


def _tom(sr: int, f0: float, seed: int) -> np.ndarray:
    n = int(0.3 * sr)
    t = np.arange(n) / sr
    freq = f0 * (1 + 0.3 * np.exp(-t / 0.03))
    phase = 2 * np.pi * np.cumsum(freq) / sr
    return (np.sin(phase) + 0.1 * _noise(n, seed)) * _env(n, sr, 0.12)


def _cymbal(sr: int, ride: bool) -> np.ndarray:
    dur = 0.9 if ride else 1.4
    n = int(dur * sr)
    partials = (2000, 3179, 4367, 5421, 6776, 8123) if ride else (
        1800, 2813, 3901, 5020, 6311, 7901)
    metallic = sum(
        np.sign(np.sin(2 * np.pi * f * np.arange(n) / sr)) for f in partials)
    x = 0.35 * metallic / len(partials) + 0.7 * _noise(n, 5 if ride else 6)
    return _highpass(x, sr, 3500) * _env(n, sr, 0.35 if ride else 0.5)


@functools.lru_cache(maxsize=4)
def default_kit(sr: int = 44100) -> tuple:
    """Sample per voice, HVO voice order (KICK..RIDE); normalized to ±0.9."""
    samples = [
        _kick(sr),
        _snare(sr),
        _hat(sr, open_=False),
        _hat(sr, open_=True),
        _tom(sr, 96, 7),   # low tom
        _tom(sr, 130, 8),  # mid tom
        _tom(sr, 175, 9),  # hi tom
        _cymbal(sr, ride=False),  # crash
        _cymbal(sr, ride=True),   # ride
    ]
    assert len(samples) == N_VOICES
    out = []
    for s in samples:
        # short fade-out: a hard truncation is a broadband click that would
        # register as a spurious onset in the MSO flux
        fade = min(int(0.01 * sr), len(s))
        s = s.copy()
        s[-fade:] *= np.linspace(1, 0, fade)
        out.append((0.9 * s / max(np.max(np.abs(s)), 1e-9)).astype(np.float32))
    return tuple(out)
