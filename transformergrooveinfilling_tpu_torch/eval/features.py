"""Rhythm feature families and evaluator stats tables, as the JAX package's
``eval/features.py`` (numpy only).

The reference logs a per-style CSV of GrooveToolbox-style features for the
ground truth and the predictions (``get_stats_from_evaluator``). The feature
names are the reference's drop-column list; the formulas are the JAX
package's, re-derived from the published definitions they cite:

- Statistical: instrument/step densities, velocity/offset moments, and the
  low/mid/high frequency-group shares (kick | snare+toms | hats+cymbals).
- Syncopation: Longuet-Higgins & Lee (1984) metrical-salience syncopation on a
  16th-note 4/4 grid, per frequency group and combined; "syness" = syncopation
  normalized by the group's hit count; Witek-style polyphonic variant.
- Micro-Timing: swingness (systematic delay of off-beat 8ths) and laidbackness
  (mean signed offset across hits).

All features are computed vectorized over stacked ``(N, T, 3V)`` arrays.
:func:`features_table` returns a :class:`FeatureTable` where the JAX package
returns a pandas DataFrame: the machine with the card has no pandas, and the
table writes the same CSV.
"""

from __future__ import annotations

import csv
import html
import os

import numpy as np

# frequency groups over the 9-voice mapping: low = kick; mid = snare + toms;
# high = hats + cymbals (GrooveToolbox convention)
LOW_VOICES = (0,)
MID_VOICES = (1, 4, 5, 6)
HIGH_VOICES = (2, 3, 7, 8)

# Longuet-Higgins & Lee metrical salience for a 16-step 4/4 bar
_LHL_SALIENCE_BAR = np.array(
    [0, -4, -3, -4, -2, -4, -3, -4, -1, -4, -3, -4, -2, -4, -3, -4])


def _salience(t: int) -> np.ndarray:
    reps = -(-t // 16)
    return np.tile(_LHL_SALIENCE_BAR, reps)[:t]


def _group_rows(h: np.ndarray, voices) -> np.ndarray:
    """(N, T, V) hits → (N, T) union row over a voice group."""
    return (h[..., list(voices)].sum(axis=-1) > 0).astype(np.float32)


def lhl_syncopation(row: np.ndarray) -> np.ndarray:
    """Monophonic LHL syncopation of an (N, T) onset row.

    An onset at position i syncopates when it is followed (cyclically) by a
    rest at the next position of strictly higher metrical salience; its score
    is that salience difference. Total = sum over such events.
    """
    n, t = row.shape
    w = _salience(t)
    score = np.zeros(n, np.float32)
    for i in range(t):
        nxt = _next_stronger(w, i, t)
        if nxt is None:  # maximal salience (downbeat) cannot syncopate
            continue
        onset_rest = (row[:, i] > 0) & (row[:, nxt] == 0)
        score += onset_rest * (w[nxt] - w[i])
    return score


def _next_stronger(w, i, t):
    """Next (cyclic) position with strictly higher metrical salience, or None."""
    for j in list(range(i + 1, t)) + list(range(0, i)):
        if w[j % t] > w[i]:
            return j % t
    return None


def witek_polyphonic_syncopation(h: np.ndarray) -> np.ndarray:
    """Polyphonic syncopation (Witek et al. 2014 flavor): LHL events of the
    low/mid groups scored against the high group carrying the beat.

    A low or mid onset on a weak position followed by a rest in its own stream
    on a stronger position counts, weighted +2 if the high stream marks that
    stronger position (cross-rhythm tension), +1 otherwise. [re-derived]
    """
    low = _group_rows(h, LOW_VOICES)
    mid = _group_rows(h, MID_VOICES)
    high = _group_rows(h, HIGH_VOICES)
    n, t = low.shape
    w = _salience(t)
    score = np.zeros(n, np.float32)
    for stream in (low, mid):
        for i in range(t):
            nxt = _next_stronger(w, i, t)
            if nxt is None:
                continue
            ev = (stream[:, i] > 0) & (stream[:, nxt] == 0)
            weight = np.where(high[:, nxt] > 0, 2.0, 1.0)
            score += ev * weight * (w[nxt] - w[i])
    return score


def vel_similarity_score(hvo: np.ndarray, reference_hvo: np.ndarray) -> np.ndarray:
    """Per-item velocity similarity vs a reference groove: ``1 − velocity-MSE
    at the reference's hit cells`` (velocities live in [0, 1], so the score
    does too; identical grooves score exactly 1).

    The reference keeps a "Vel Similarity Score" column out of its drop
    list; its formula is not published, so this is the JAX package's
    re-derived measure: how well the prediction's velocities match ground
    truth where ground truth actually has hits.
    """
    n_v = hvo.shape[-1] // 3
    v_self = hvo[..., n_v : 2 * n_v]
    v_ref = reference_hvo[..., n_v : 2 * n_v]
    h_ref = (reference_hvo[..., :n_v] > 0).astype(np.float32)
    sq = ((v_self - v_ref) ** 2) * h_ref
    return 1.0 - sq.sum(axis=(1, 2)) / np.maximum(h_ref.sum(axis=(1, 2)), 1)


def statistical_features(hvo: np.ndarray, reference_hvo: np.ndarray | None = None) -> dict:
    """``Statistical::*`` family over a stacked ``(N, T, 3V)`` array → dict of
    (N,) vectors.

    ``reference_hvo``: comparison corpus for the similarity feature (the GT
    stack when scoring predictions); omitted → self-comparison (score 1)."""
    n_v = hvo.shape[-1] // 3
    h = hvo[..., :n_v]
    v = hvo[..., n_v : 2 * n_v]
    o = hvo[..., 2 * n_v :]
    t = h.shape[1]
    hits_per_item = h.sum(axis=(1, 2))
    safe_hits = np.maximum(hits_per_item, 1)

    def _masked_moments(values):
        mean = (values * h).sum(axis=(1, 2)) / safe_hits
        var = (((values - mean[:, None, None]) ** 2) * h).sum(axis=(1, 2)) / safe_hits
        return mean, np.sqrt(var)

    vel_mean, vel_std = _masked_moments(v)
    off_mean, off_std = _masked_moments(o)

    low = h[..., list(LOW_VOICES)].sum(axis=(1, 2))
    mid = h[..., list(MID_VOICES)].sum(axis=(1, 2))
    high = h[..., list(HIGH_VOICES)].sum(axis=(1, 2))

    return {
        "NoI": (h.sum(axis=1) > 0).sum(axis=1).astype(np.float32),
        "Total Step Density": (h.sum(axis=2) > 0).mean(axis=1),
        "Avg Voice Density": h.mean(axis=(1, 2)) * n_v,  # hits/step per voice
        "Lowness": low / safe_hits,
        "Midness": mid / safe_hits,
        "Hiness": high / safe_hits,
        "Vel Similarity Score": vel_similarity_score(
            hvo, reference_hvo if reference_hvo is not None else hvo),
        "Weak to Strong Ratio": _weak_to_strong(h),
        "Poly Velocity Mean": vel_mean,
        "Poly Velocity std": vel_std,
        "Poly Offset Mean": off_mean,
        "Poly Offset std": off_std,
    }


def _weak_to_strong(h: np.ndarray) -> np.ndarray:
    w = _salience(h.shape[1])
    strong = h[:, w >= -1, :].sum(axis=(1, 2))
    weak = h[:, w < -1, :].sum(axis=(1, 2))
    return weak / np.maximum(strong, 1)


def syncopation_features(hvo: np.ndarray) -> dict:
    n_v = hvo.shape[-1] // 3
    h = hvo[..., :n_v]
    low = _group_rows(h, LOW_VOICES)
    mid = _group_rows(h, MID_VOICES)
    high = _group_rows(h, HIGH_VOICES)
    lowsync = lhl_syncopation(low)
    midsync = lhl_syncopation(mid)
    hisync = lhl_syncopation(high)
    combined = lowsync + midsync + hisync
    poly = witek_polyphonic_syncopation(h)
    dens = (h.sum(axis=2) > 0).mean(axis=1)

    def _ness(sync, row):
        return sync / np.maximum(row.sum(axis=1), 1)

    return {
        "Combined": combined,
        "Polyphonic": poly,
        "Lowsync": lowsync,
        "Midsync": midsync,
        "Hisync": hisync,
        "Lowsyness": _ness(lowsync, low),
        "Midsyness": _ness(midsync, mid),
        "Hisyness": _ness(hisync, high),
        # complexity: density-syncopation magnitude (re-derived)
        "Complexity": np.sqrt(dens**2 + (_ness(combined, (h.sum(2) > 0)) ** 2)),
    }


def microtiming_features(hvo: np.ndarray) -> dict:
    n_v = hvo.shape[-1] // 3
    h = hvo[..., :n_v]
    o = hvo[..., 2 * n_v :]
    t = h.shape[1]
    # off-beat 8th positions on a 16th grid: steps 2, 6, 10, 14 (mod 16)
    swing_pos = np.array([i for i in range(t) if i % 4 == 2])
    swing_hits = h[:, swing_pos, :]
    swing_off = o[:, swing_pos, :]
    swingness = (swing_off * swing_hits).sum(axis=(1, 2)) / np.maximum(
        swing_hits.sum(axis=(1, 2)), 1)
    laidback = (o * h).sum(axis=(1, 2)) / np.maximum(h.sum(axis=(1, 2)), 1)
    return {
        "Swingness": np.maximum(swingness, 0.0) * 2,  # positive delay = swing
        "Laidbackness": laidback,
        "Timing Accuracy": 1.0 - np.minimum(
            np.abs(o * h).sum(axis=(1, 2)) / np.maximum(h.sum(axis=(1, 2)), 1),
            1.0),
    }


ALL_FAMILIES = {
    "Statistical": statistical_features,
    "Syncopation": syncopation_features,
    "Micro-Timing": microtiming_features,
}

# columns the reference drops as irrelevant to infilling
INFILLING_DROP_COLUMNS = [
    f"{fam}::{feat}__{src}"
    for src in ("Ground_Truth", "Prediction")
    for fam, feats in (
        ("Statistical", ("Lowness", "Midness", "Hiness", "Poly Velocity Mean",
                         "Poly Velocity std", "Poly Offset Mean",
                         "Poly Offset std")),
        ("Syncopation", ("Combined", "Polyphonic", "Lowsync", "Midsync",
                         "Hisync", "Lowsyness", "Midsyness", "Hisyness",
                         "Complexity")),
        ("Micro-Timing", ("Swingness", "Laidbackness")),
    )
    for feat in feats
]


class FeatureTable:
    """The per-style features table: row labels ``index``, ``columns``, one
    float per row in each column, and the part of a pandas DataFrame's
    surface the media pass uses."""

    def __init__(self, columns: dict, index: list):
        self.index = list(index)
        self._columns = {name: list(values) for name, values in columns.items()}

    @property
    def columns(self) -> list:
        return list(self._columns)

    def __getitem__(self, column: str) -> np.ndarray:
        return np.asarray(self._columns[column], np.float64)

    def drop(self, columns) -> "FeatureTable":
        """A copy without ``columns``; a name the table lacks raises ``KeyError``."""
        gone = set(columns)
        missing = gone.difference(self._columns)
        if missing:
            raise KeyError(f"{sorted(missing)} not found in the columns")
        return FeatureTable({k: v for k, v in self._columns.items() if k not in gone},
                            self.index)

    def dropna(self, axis: int = 1) -> "FeatureTable":
        """A copy without the columns that hold a NaN (``axis=1`` only)."""
        if axis != 1:
            raise ValueError("FeatureTable.dropna drops columns only (axis=1)")
        return FeatureTable({k: v for k, v in self._columns.items()
                             if not any(np.isnan(x) for x in v)}, self.index)

    def to_csv(self, path: str) -> None:
        """pandas' ``to_csv`` layout: an empty index header, floats as
        ``repr``, NaN as an empty cell."""
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow([""] + self.columns)
            for row, label in enumerate(self.index):
                writer.writerow([label] + ["" if np.isnan(v[row]) else repr(float(v[row]))
                                           for v in self._columns.values()])

    def to_html(self) -> str:
        """An HTML table: a header row of the columns, one row per label."""
        head = "".join(f"<th>{html.escape(c)}</th>" for c in self.columns)
        rows = "".join(
            f"<tr><th>{html.escape(str(label))}</th>"
            + "".join(f"<td>{v[row]:.6g}</td>" for v in self._columns.values()) + "</tr>"
            for row, label in enumerate(self.index))
        return (f'<table border="1" class="dataframe"><thead><tr style="text-align: right;">'
                f"<th></th>{head}</tr></thead><tbody>{rows}</tbody></table>")


def features_table(gt: np.ndarray, pred: np.ndarray, tags: list) -> FeatureTable:
    """Per-style mean of every feature for GT and predictions (rows = style
    tags + Overall, columns = ``Family::Feature__Source``)."""
    tags_arr = np.asarray(tags)
    unique_tags = sorted(set(tags))
    columns: dict[str, list] = {}
    for src_name, arr in (("Ground_Truth", gt), ("Prediction", pred)):
        for fam, fn in ALL_FAMILIES.items():
            # the similarity feature scores each source against GT: the
            # Prediction column measures velocity fidelity at GT-hit cells
            # (GT against itself is exactly 1)
            kwargs = {"reference_hvo": np.asarray(gt)} if fam == "Statistical" else {}
            feats = fn(np.asarray(arr), **kwargs)
            for feat, vec in feats.items():
                per_tag = [float(np.mean(vec[tags_arr == t])) for t in unique_tags]
                per_tag.append(float(np.mean(vec)))
                columns[f"{fam}::{feat}__{src_name}"] = per_tag
    return FeatureTable(columns, unique_tags + ["Overall"])


def get_stats_from_evaluator(evaluator, csv_file: str | None = None) -> FeatureTable:
    """Reference ``get_stats_from_evaluator`` contract → the table (+ CSV)."""
    table = features_table(evaluator._gt_hvos_array, evaluator._prediction_hvos_array,
                           evaluator._gt_hvos_array_tags)
    if csv_file:
        os.makedirs(os.path.dirname(csv_file) or ".", exist_ok=True)
        table.to_csv(csv_file)
    return table
