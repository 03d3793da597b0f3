"""Host-side HVO sequence record, as the JAX package's ``hvo/sequence.py``.

A thin numpy-backed record: the ``(T, 3V)`` grid plus musical metadata, with
the voice-masking, random-masking and synthesis methods the datasets need.
The dataclasses have the JAX package's fields, so a pickle of either
package's records carries its state over to the other's classes
(``data/legacy_pickle.py`` reads, ``utils/serialization.py`` writes).

``synthesize``, ``save_audio`` and ``mso`` render through the port's
``audio/synth.py`` and ``ops/mso.py``; ``mso`` computes on ``device``
(``"cuda"`` unless the caller asks for the CPU). ``to_html_plot`` renders the
piano roll of ``eval/media.py``.
"""

from __future__ import annotations

import copy as _copy
from dataclasses import asdict, dataclass, field

import numpy as np

from .mapping import N_VOICES, ROLAND_REDUCED_MAPPING


@dataclass
class TimeSignature:
    time_step: int = 0
    numerator: int = 4
    denominator: int = 4
    beat_division_factors: tuple = (4,)

    def __str__(self):
        return f"{self.numerator}-{self.denominator}"


@dataclass
class Tempo:
    time_step: int = 0
    qpm: float = 120.0


@dataclass
class Metadata:
    """Per-loop provenance used for style subsetting and media captions."""

    drummer: str = ""
    session: str = ""
    master_id: str = ""
    style_primary: str = ""
    style_secondary: str = ""
    beat_type: str = ""
    loop_id: str = ""
    bpm: float = 0.0

    def to_dict(self):
        return asdict(self)

    def __getitem__(self, key):
        return getattr(self, key)


@dataclass
class HVOSequence:
    """A 2-bar drum loop as a fixed-width hits/velocities/offsets grid."""

    hvo: np.ndarray = field(default_factory=lambda: np.zeros((32, 3 * N_VOICES)))
    time_signatures: list = field(default_factory=lambda: [TimeSignature()])
    tempos: list = field(default_factory=lambda: [Tempo()])
    metadata: Metadata = field(default_factory=Metadata)
    drum_mapping: dict = field(default_factory=lambda: dict(ROLAND_REDUCED_MAPPING))

    @property
    def n_voices(self) -> int:
        return len(self.drum_mapping)

    @property
    def hits(self) -> np.ndarray:
        return self.hvo[:, : self.n_voices]

    @property
    def velocities(self) -> np.ndarray:
        return self.hvo[:, self.n_voices : 2 * self.n_voices]

    @property
    def offsets(self) -> np.ndarray:
        return self.hvo[:, 2 * self.n_voices :]

    def get(self, name: str) -> np.ndarray:
        """The reference's getter: ``"hvo"``, ``"h"``, ``"v"`` or ``"o"``."""
        if name == "hvo":
            return self.hvo
        if name == "h":
            return self.hits
        if name == "v":
            return self.velocities
        if name == "o":
            return self.offsets
        raise KeyError(name)

    def copy(self) -> "HVOSequence":
        return _copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "HVOSequence":
        """Structure-aware deep copy: every standard field holds immutables
        below one level, so targeted copies give full deep-copy semantics;
        attributes a caller attached go through ``copy.deepcopy``."""
        out = HVOSequence(
            hvo=self.hvo.copy(),
            time_signatures=[_copy.copy(ts) for ts in self.time_signatures],
            tempos=[_copy.copy(t) for t in self.tempos],
            metadata=_copy.copy(self.metadata),
            drum_mapping={k: _copy.copy(v) for k, v in self.drum_mapping.items()},
        )
        memo[id(self)] = out
        std = {"hvo", "time_signatures", "tempos", "metadata", "drum_mapping"}
        for k, v in vars(self).items():
            if k not in std:
                setattr(out, k, _copy.deepcopy(v, memo))
        return out

    def copy_empty(self) -> "HVOSequence":
        """A copy with the grid zeroed and the metadata kept."""
        out = self.copy()
        out.hvo = np.zeros_like(self.hvo)
        return out

    def get_active_voices(self) -> np.ndarray:
        """Indices of voices with at least one hit."""
        return np.nonzero(np.any(self.hits > 0, axis=0))[0]

    def reset_voices(self, voice_idx):
        """→ (input_seq, removed_seq): the first keeps every voice but
        ``voice_idx`` (zeroed across the h/v/o triple), the second holds only
        ``voice_idx``."""
        voice_idx = [voice_idx] if np.isscalar(voice_idx) else list(voice_idx)
        n = self.n_voices
        cols = np.array([v for i in voice_idx for v in (i, i + n, i + 2 * n)], dtype=int)
        kept = self.copy()
        removed = self.copy()
        removed.hvo = np.zeros_like(self.hvo)
        if cols.size:
            removed.hvo[:, cols] = self.hvo[:, cols]
            kept.hvo[:, cols] = 0.0
        return kept, removed

    def remove_random_events(self, thres_range=(0.4, 0.6), rng=None):
        """→ (kept, removed): a threshold drawn uniformly from
        ``thres_range``, each active event removed independently with that
        probability (velocity and offset follow their hit)."""
        rng = rng or np.random.default_rng()
        thres = rng.uniform(*thres_range)
        h = self.hits
        remove = (rng.random(h.shape) < thres) & (h > 0)
        remove3 = np.concatenate([remove, remove, remove], axis=1)
        kept = self.copy()
        removed = self.copy()
        kept.hvo = np.where(remove3, 0.0, self.hvo)
        removed.hvo = np.where(remove3, self.hvo, 0.0)
        return kept, removed

    def pad_to_length(self, max_len: int) -> "HVOSequence":
        """Zero-pad or truncate the time axis in place."""
        t = self.hvo.shape[0]
        if t < max_len:
            self.hvo = np.pad(self.hvo, ((0, max_len - t), (0, 0)))
        self.hvo = self.hvo[:max_len, :]
        return self

    def is_silent(self) -> bool:
        return not np.any(self.hvo)

    def synthesize(self, sf_path=None, sr: int = 44100) -> np.ndarray:
        """Render the loop to a waveform with the host mixer, through the
        ``.sf2`` kit at ``sf_path`` (None: the procedural kit)."""
        from ..audio.synth import synthesize_hvo

        return synthesize_hvo(self.hvo, qpm=self.tempos[0].qpm or 120.0, sf_path=sf_path, sr=sr)

    def save_audio(self, filename: str, sr: int = 44100, sf_path=None) -> np.ndarray:
        from ..audio.synth import write_wav

        y = self.synthesize(sf_path=sf_path, sr=sr)
        write_wav(filename, y, sr)
        return y

    def mso(self, sf_path=None, device="cuda", **mso_params) -> np.ndarray:
        """The multiband synthesized onsets input ``(T, n_bands)``: the loop
        rendered, then the MSO DSP on ``device``."""
        from ..ops.mso import MSOParams, mso_from_audio

        params = MSOParams(**mso_params) if mso_params else MSOParams()
        y = self.synthesize(sf_path=sf_path, sr=params.sr)
        # the same falsy-qpm guard as synthesize(): qpm 0 would pool every
        # onset into step 0 while the audio renders at the 120 default
        return np.asarray(mso_from_audio(y, n_steps=self.hvo.shape[0],
                                         qpm=self.tempos[0].qpm or 120.0, params=params,
                                         device=device))

    def to_html_plot(self, filename: str = "piano_roll", show_figure: bool = False):
        """Self-contained HTML piano roll (no bokeh)."""
        from ..eval.media import piano_roll_html

        return piano_roll_html(self, title=filename)


def empty_like(seq: HVOSequence) -> HVOSequence:
    return seq.copy_empty()
