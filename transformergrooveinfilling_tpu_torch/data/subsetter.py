"""Corpus subsetting: GMD pickles → filtered HVO sequence lists, as the JAX
package's ``data/subsetter.py``.

Loads ``<pickle_source_path>/<subset>/<hvo_pickle_filename>`` and splits it
into one subset per filter dict, keyed by metadata. Accepted sources, probed
in order:

1. an in-memory list of :class:`HVOSequence` (tests, the synthetic corpus),
2. a pickle of sequences that either package wrote,
3. a reference-era pickle, read through ``data/legacy_pickle.py`` so that the
   absent ``hvo_sequence`` classes resolve to the port's own.
"""

from __future__ import annotations

import os

from ..hvo import HVOSequence
from .legacy_pickle import legacy_load, to_native

# every filterable key: the metadata fields plus time_signature.
# _sequence_matches validates against this so a misspelled key fails loudly
# instead of silently excluding every sequence.
FILTER_KEYS = ("drummer", "session", "master_id", "style_primary",
               "style_secondary", "beat_type", "loop_id", "bpm",
               "time_signature")


def _sequence_matches(seq: HVOSequence, filt: dict | None) -> bool:
    if not filt:
        return True
    unknown = set(filt) - set(FILTER_KEYS)
    if unknown:
        raise ValueError(
            f"unknown subset filter key(s) {sorted(unknown)}; "
            f"supported: {FILTER_KEYS}")
    for key, allowed in filt.items():
        if allowed in (None, "", []):
            continue
        allowed = allowed if isinstance(allowed, (list, tuple)) else [allowed]
        if key == "time_signature":
            value = str(seq.time_signatures[0])
        elif key == "bpm":
            value = seq.metadata.bpm
        else:
            value = getattr(seq.metadata, key, None)
        if value not in allowed:
            return False
    return True


def _filter_tag(filt: dict | None, index: int) -> str:
    if filt:
        for key in ("style_primary", "master_id", "beat_type"):
            v = filt.get(key)
            if v:
                return v[0] if isinstance(v, (list, tuple)) else str(v)
    return f"subset_{index}"


class GrooveMidiSubsetter:
    def __init__(
        self,
        pickle_source_path: str = "",
        subset: str = "",
        hvo_pickle_filename: str = "hvo_sequence_data.obj",
        list_of_filter_dicts_for_subsets=None,
        sequences=None,
    ):
        self.pickle_source_path = pickle_source_path
        self.subset = subset
        self.hvo_pickle_filename = hvo_pickle_filename
        self.filters = list_of_filter_dicts_for_subsets or [None]
        self._sequences = sequences

    def _load_sequences(self):
        if self._sequences is not None:
            return self._sequences
        path = os.path.join(
            self.pickle_source_path, self.subset, self.hvo_pickle_filename
        )
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"GMD pickle not found: {path}. Provide `sequences=` or generate a "
                "corpus with data.synthetic."
            )
        return [to_native(s) for s in legacy_load(path)]

    def create_subsets(self):
        """→ (tags, subset_list): one list of sequences per filter dict."""
        seqs = self._load_sequences()
        tags, subsets = [], []
        for i, filt in enumerate(self.filters):
            tags.append(_filter_tag(filt, i))
            subsets.append([s for s in seqs if _sequence_matches(s, filt)])
        return tags, subsets
