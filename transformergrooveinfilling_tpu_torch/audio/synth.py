"""HVO → waveform rendering on the host, as the JAX package's
``audio/synth.py``.

An HVO grid renders as sample accumulation: for every hit, its voice's sample
from the procedural kit is added at the hit's onset time (grid step +
fractional offset, in 16th-note units at the loop's tempo), scaled by the SF2
default modulator's velocity gain (:func:`velocity_gain`). There is one mixer,
the numpy one; the on-device synthesizer is held against it.

:func:`write_wav` writes a 16-bit mono WAV file through the standard
library's ``wave``, as the JAX package does.

Not ported yet: SoundFont kits (a ``sf_path`` other than None raises
``NotPortedError``), the C++ mixer, ``read_wav`` and ``synthesize_hvo_list``.
"""

from __future__ import annotations

import os
import wave

import numpy as np

from .. import NotPortedError
from .drumkit import default_kit, kit_layers

_TAIL_SECONDS = 1.0  # let the last hits ring out (cymbal decay)


def velocity_gain(vel_midi):
    """MIDI velocity → amplitude per the SF2 default modulator, closed form:
    the concave velocity → attenuation curve (400·log10(127/v) cB) collapses
    to exactly ``(v/127)²`` for v in [1, 127]; v = 0 renders silence. Takes and
    returns numpy arrays or scalars."""
    v = np.asarray(vel_midi, np.float32) / np.float32(127.0)
    return v * v


def _sample_table(sf_path: str | None, sr: int):
    if sf_path is None:
        return default_kit(sr)
    raise NotPortedError(
        f"SoundFont kits are not ported yet (sf_path={sf_path!r}); pass None "
        "for the procedural kit")


def steps_per_second(qpm):
    """16th-note grid steps per second at the given tempo."""
    return (qpm / 60.0) * 4.0


def synthesize_hvo(hvo: np.ndarray, qpm: float = 120.0, sf_path: str | None = None,
                   sr: int = 44100) -> np.ndarray:
    """Render one ``(T, 3V)`` grid to a float32 waveform."""
    return synthesize_hvo_batch(np.asarray(hvo)[None], np.asarray([qpm]), [sf_path], sr=sr)[0]


def synthesize_hvo_batch(hvos: np.ndarray, qpms, sf_paths, sr: int = 44100,
                         fixed_length: int | None = None,
                         normalize: bool = True) -> np.ndarray:
    """Render a stacked ``(M, T, 3V)`` batch → ``(M, L)`` float32 waveforms,
    all padded to a common length (the slowest tempo's loop + ring-out tail)."""
    hvos = np.asarray(hvos, dtype=np.float32)
    m, t, width = hvos.shape
    n_voices = width // 3
    qpms = np.asarray(qpms, dtype=np.float64)
    if qpms.size == 1 and m > 1:
        qpms = np.full((m,), float(qpms))
    sps = steps_per_second(qpms)  # (M,) steps/sec
    loop_len = t / sps            # seconds

    # a batch with K distinct kits concatenates their flat samples once, and
    # events address the union via (base offset + velocity-layer LUT)
    unique_sfs = list(dict.fromkeys(sf_paths))
    tables = {sf: _sample_table(sf, sr) for sf in unique_sfs}
    base_arr = np.zeros(len(unique_sfs), np.int64)
    lut_list = []
    combined: list = []
    for k, sf in enumerate(unique_sfs):
        flat, lut = kit_layers(tables[sf])
        base_arr[k] = len(combined)
        combined.extend(flat)
        lut_list.append(lut)
    luts = np.stack(lut_list) if lut_list else np.zeros((0, 0, 128), np.int32)
    sf_to_k = {sf: k for k, sf in enumerate(unique_sfs)}
    max_sample = max((len(s) for s in combined), default=0)
    if fixed_length is None:
        fixed_length = int(np.ceil(loop_len.max() * sr)) + max(
            int(_TAIL_SECONDS * sr), max_sample)

    out = np.zeros((m, fixed_length), dtype=np.float32)
    # np.nonzero is row-major: events come out grouped by item, step major,
    # voice minor
    items, steps, voices = np.nonzero(hvos[:, :, :n_voices] > 0)
    if items.size:
        offs = hvos[items, steps, 2 * n_voices + voices]
        vels = hvos[items, steps, n_voices + voices].astype(np.float32)
        onsets = np.clip((steps + offs) / sps[items] * sr, 0, fixed_length - 1).astype(np.int64)
        item_k = np.asarray([sf_to_k[sf] for sf in sf_paths], np.int64)[items]
        vel_midi = np.clip(np.rint(vels * 127).astype(np.int64), 0, 127)
        gains = velocity_gain(vel_midi)
        voice_idx = (base_arr[item_k] + luts[item_k, voices, vel_midi]).astype(np.int32)
        event_offsets = np.zeros(m + 1, np.int64)
        np.cumsum(np.bincount(items, minlength=m), out=event_offsets[1:])
        for i in range(m):
            lo, hi = event_offsets[i], event_offsets[i + 1]
            _mix_events_numpy(out[i], combined, voice_idx[lo:hi], onsets[lo:hi], gains[lo:hi])

    # prevent clipping without changing an item's internal dynamics, per item
    if normalize:
        peak = np.max(np.abs(out), axis=-1, keepdims=True, initial=1e-9)
        np.divide(out, peak, out=out, where=peak > 1.0)
    return out


def _mix_events_numpy(buf: np.ndarray, table, voices: np.ndarray, onsets: np.ndarray,
                      vels: np.ndarray):
    n = len(buf)
    for voice, onset, vel in zip(voices, onsets, vels):
        s = table[voice]
        end = min(onset + len(s), n)
        if end > onset:
            buf[onset:end] += vel * s[: end - onset]


def write_wav(filename: str, y: np.ndarray, sr: int = 44100) -> None:
    """A float waveform in [-1, 1] (clipped) → a 16-bit mono WAV file."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    pcm16 = (np.clip(np.asarray(y), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(filename, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())

