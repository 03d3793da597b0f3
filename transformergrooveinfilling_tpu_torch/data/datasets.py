"""Infilling task datasets, as the JAX package's ``data/datasets.py``.

The reference's three dataset classes, built in two passes:

- the planning pass (which item × soundfont × voice-combination pairs to
  materialize; ragged, metadata-scale) is a small host loop of seeded
  stdlib-random draws, in the JAX package's order;
- the array pass masks every grid at once on one stacked ``(M, T, 3V)``
  array, and for the audio modality renders and analyses them through
  ``ops/mso.py::mso_batch_from_hvo`` on the dataset's ``device``: on the card
  that is the on-device synthesizer and the band-energy kernel
  (``csrc/device_synth.cu``, ``csrc/band_energies.cu``); ``device="cpu"``
  takes the host mixer and the rFFT.

From the same corpus and seed, the masks, plans, indices and outputs equal
the JAX package's bit for bit; only the MSO inputs carry float differences.
Datasets hold their processed arrays as float32 numpy arrays. The attribute
surface (``processed_inputs``/``processed_outputs``/``hvo_sequences*``/
``hvo_index``/``voices_reduced``/``soundfonts``/``unused_items``,
``__len__``/``__getitem__``, pickles with versioned names) is the
reference's. The pickles name the JAX package's record classes
(``utils/serialization.py``), so a dataset directory written by either
package loads in the other.
"""

from __future__ import annotations

import copy
import os
import random as _random
from datetime import datetime

import numpy as np

from .. import require_device
from ..hvo import HVOSequence, N_VOICES
from ..utils import logging as xlog
from ..utils.serialization import save_to_pickle
from .legacy_pickle import legacy_load, to_native
from .samplers import (
    get_sf_list,
    get_sf_v_combinations,
    get_voice_idx_for_item,
)

DEFAULT_MSO_PARAMS = {
    "sr": 44100,
    "n_fft": 1024,
    "win_length": 1024,
    "hop_length": 441,
    "n_bins_per_octave": 16,
    "n_octaves": 9,
    "f_min": 40,
    "mean_filter_size": 22,
}

DEFAULT_VOICES_PARAMS = {
    "voice_idx": [0, 1],
    "min_n_voices_to_remove": 1,
    "max_n_voices_to_remove": 2,
    "prob": [1, 1],
    "k": 5,
}


def _mask_voices_batch(hvos: np.ndarray, voice_masks: np.ndarray):
    """Vectorized reset_voices over a stacked batch: (M,T,3V), (M,V) → kept, removed."""
    cmask = np.concatenate([voice_masks] * 3, axis=-1)[:, None, :]  # (M,1,3V)
    removed = np.where(cmask, hvos, 0.0)
    kept = np.where(cmask, 0.0, hvos)
    return kept, removed


class GrooveMidiDatasetInfilling:
    """Audio-modality infilling dataset: input = MSO of the partial loop,
    target = the removed voices' HVO grid. A build computes on ``device``
    (``"cuda"`` without CUDA raises); loading a directory computes nothing,
    and a later :meth:`process_dataset` (the evaluator's) computes on
    ``device`` then. The device is the holder's: a pickle of the dataset
    leaves it out, and unpickling sets ``"cuda"``."""

    __version__ = "0.1.2"

    def __init__(self, data=None, load_dataset_path=None, seed: int | None = None,
                 device="cuda", **kwargs):
        self._rng = _random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._device = device if load_dataset_path else require_device(device,
                                                                        type(self).__name__)

        if load_dataset_path:
            parts = [p for p in load_dataset_path.split("/") if p]
            self.dataset_name = parts[-1] if parts else "Dataset"
            self._load_params(load_dataset_path)
            processed = self._load_processed(load_dataset_path)
        else:
            self._init_params(kwargs)
            processed = self.process_dataset(data)

        for key, val in processed.items():
            setattr(self, key, val)

        params = self.get_params()
        if xlog.ensure_configured():
            xlog.config.update(params, allow_val_change=True)

        if load_dataset_path is None and kwargs.get("save", True):
            self._save(processed, params)

    # -- parameter handling ----------------------------------------------------

    def _init_params(self, kwargs):
        self.max_seq_len = kwargs.get("max_seq_len", 32)
        self.mso_params = kwargs.get("mso_params", dict(DEFAULT_MSO_PARAMS))
        self.voices_params = kwargs.get("voices_params", dict(DEFAULT_VOICES_PARAMS))
        self.sf_path = kwargs.get("sf_path", None)
        self.max_n_sf = kwargs.get("max_n_sf", None)
        self.max_aug_items = kwargs.get("max_aug_items", 10)
        self.timestamp = datetime.now().strftime("%d_%m_%Y_at_%H_%M_hrs")
        self.dataset_name = kwargs.get("dataset_name") or ("Dataset_" + self.timestamp)
        self.subset_info = kwargs.get(
            "subset_info",
            {"pickle_source_path": "", "subset": "", "metadata_csv_filename": "",
             "hvo_pickle_filename": "", "filters": ""},
        )
        self.split = kwargs.get("split", "")
        self.sfs_list = get_sf_list(self.sf_path)
        if self.max_n_sf is not None:
            if self.max_n_sf > len(self.sfs_list):
                raise ValueError("max_n_sf can not be larger than number of available "
                                 "soundfonts")
        self.save_dataset_path = kwargs.get(
            "save_dataset_path", os.path.join("dataset", self.dataset_name))

    def get_params(self) -> dict:
        params = copy.deepcopy(
            {k: v for k, v in self.__dict__.items()
             if not k.startswith("_") and k not in (
                 "processed_inputs", "processed_outputs", "hvo_sequences",
                 "hvo_sequences_inputs", "hvo_sequences_outputs")}
        )
        return params

    # -- construction ----------------------------------------------------------

    def _plan_items(self, data):
        """Host planning pass → (valid sequences, flat augmentation plan).

        Returns ``sequences`` (padded, filtered) and a plan list of
        ``(seq_pos, hvo_idx, voice_idx_tuple, soundfont)`` plus unused hvo_idx.
        """
        sequences, plan, unused = [], [], []
        for hvo_idx, hvo_seq in enumerate(data):
            if len(hvo_seq.time_signatures) != 1 or hvo_seq.is_silent():
                continue
            hvo_seq = hvo_seq.copy().pad_to_length(self.max_seq_len)
            seq_pos = len(sequences)
            sequences.append(hvo_seq)
            voice_idx, voices_params = get_voice_idx_for_item(
                hvo_seq, self.voices_params)
            if len(voice_idx) == 0:
                unused.append(hvo_idx)
                continue
            combos = list(get_sf_v_combinations(
                voices_params, self.max_aug_items, self.max_n_sf, self.sfs_list,
                rng=self._rng,
            ))
            if not combos:
                # too few active voices for any removal set of the configured
                # minimum size: item is unused, like the zero-candidate case
                unused.append(hvo_idx)
                continue
            for sf, v_idx in combos:
                v_tuple = (v_idx,) if np.isscalar(v_idx) else tuple(v_idx)
                plan.append((seq_pos, hvo_idx, v_tuple, sf))
        return sequences, plan, unused

    def _collect_entries(self, sequences, entries, kept, removed, unused):
        """Shared keep_entry filter + row collection for every dataset family.

        ``entries``: ``(seq_pos, hvo_idx, *extras)`` tuples — ``seq_pos``
        indexes the *filtered* ``sequences`` list, ``hvo_idx`` the original
        corpus (the reference's ``hvo_index`` semantics). Returns parallel
        lists plus the stacked kept/removed arrays; entries whose kept or
        removed side is fully silent are dropped and marked unused
        (reference dataset.py:238-244)."""
        keep_entry = (
            np.any(kept.reshape(len(entries), -1) != 0, axis=1)
            & np.any(removed.reshape(len(entries), -1) != 0, axis=1)
        ) if entries else np.zeros((0,), bool)

        hvo_index, seq_index, extras_kept = [], [], []
        seq_inputs, seq_outputs, kept_rows, removed_rows = [], [], [], []
        for i, entry in enumerate(entries):
            seq_pos, hvo_idx = entry[0], entry[1]
            if not keep_entry[i]:
                unused.append(hvo_idx)
                continue
            base = sequences[seq_pos]
            s_in, s_out = base.copy(), base.copy()
            s_in.hvo, s_out.hvo = kept[i], removed[i]
            seq_inputs.append(s_in)
            seq_outputs.append(s_out)
            kept_rows.append(kept[i])
            removed_rows.append(removed[i])
            hvo_index.append(hvo_idx)
            seq_index.append(seq_pos)
            extras_kept.append(entry[2:])

        kept_arr = (np.stack(kept_rows) if kept_rows
                    else np.zeros((0, self.max_seq_len, 3 * N_VOICES),
                                  np.float32))
        removed_arr = (np.stack(removed_rows) if removed_rows
                       else np.zeros_like(kept_arr))
        return (seq_inputs, seq_outputs, kept_arr, removed_arr, hvo_index,
                seq_index, extras_kept, unused)

    def _materialize_voice_masking(self, sequences, plan, unused):
        """Vectorized array pass shared by the audio and symbolic variants."""
        if not plan:
            empty = np.zeros((0, self.max_seq_len, 3 * N_VOICES), np.float32)
            return (sequences, [], empty, empty.copy(), [], [], [], unused,
                    [], [])
        stacked = np.stack([sequences[p[0]].hvo for p in plan]).astype(np.float32)
        masks = np.zeros((len(plan), N_VOICES), dtype=bool)
        for i, (_, _, v_tuple, _) in enumerate(plan):
            masks[i, list(v_tuple)] = True
        kept, removed = _mask_voices_batch(stacked, masks)

        (seq_inputs, seq_outputs, kept_arr, removed_arr, hvo_index, seq_index,
         extras, unused) = self._collect_entries(
            sequences, plan, kept, removed, unused)
        voices_reduced = [list(v) for v, _sf in extras]
        soundfonts = [sf for _v, sf in extras]
        return (sequences, seq_inputs, kept_arr, removed_arr, hvo_index,
                voices_reduced, soundfonts, unused, seq_outputs, seq_index)

    def _finalize_save_path(self):
        """Append ``<version>/<split>`` to the save path exactly once —
        process_dataset may run again on the same object (the evaluator
        re-runs it on GT sequences, eval/evaluator.py), and repeated joins
        would silently deepen the path every call."""
        suffix = os.path.join(self.__version__, self.split)
        if not self.save_dataset_path.endswith(suffix):
            self.save_dataset_path = os.path.join(
                self.save_dataset_path, suffix)

    def process_dataset(self, data) -> dict:
        self._finalize_save_path()
        sequences, plan, unused = self._plan_items(data)
        (sequences, seq_inputs, kept_arr, removed_arr, hvo_index, voices_reduced,
         soundfonts, unused, seq_outputs, seq_index) = \
            self._materialize_voice_masking(sequences, plan, unused)

        qpms = np.asarray(
            [s.tempos[0].qpm for s in seq_inputs], dtype=np.float32)
        processed_inputs = self._compute_msos(kept_arr, soundfonts, qpms)

        return {
            "processed_inputs": processed_inputs.astype(np.float32),
            "processed_outputs": removed_arr.astype(np.float32),
            "hvo_sequences": sequences,
            "hvo_sequences_inputs": seq_inputs,
            "hvo_sequences_outputs": seq_outputs,
            "hvo_index": hvo_index,
            "hvo_seq_index": seq_index,
            "voices_reduced": voices_reduced,
            "soundfonts": soundfonts,
            "unused_items": unused,
        }

    def _compute_msos(self, kept_arr, soundfonts, qpms) -> np.ndarray:
        """Batched synthesize → MSO for every augmented input grid, on the
        dataset's device."""
        from ..ops.mso import MSOParams, mso_batch_from_hvo

        return mso_batch_from_hvo(kept_arr, soundfonts, qpms,
                                  params=MSOParams(**self.mso_params), device=self._device)

    def __getstate__(self):
        # the JAX package's dataset has no device, and its pickles cannot hold
        # a torch.device (utils/serialization.py)
        state = dict(self.__dict__)
        state.pop("_device", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device = "cuda"

    # -- persistence -----------------------------------------------------------

    def _pickle_names(self):
        stem = f"{self.dataset_name}_{self.split}_{self.__version__}"
        return stem + "_params.pickle", stem + "_dataset.pickle"

    def _save(self, processed, params):
        os.makedirs(self.save_dataset_path, exist_ok=True)
        params_name, dataset_name = self._pickle_names()
        save_to_pickle(params, os.path.join(self.save_dataset_path, params_name))
        save_to_pickle(processed, os.path.join(self.save_dataset_path, dataset_name))

    def _load_params(self, dataset_path):
        fname = next(
            f for f in sorted(os.listdir(dataset_path))
            if f.endswith("_params.pickle"))
        params = legacy_load(os.path.join(dataset_path, fname))
        for key, val in params.items():
            setattr(self, key, val)

    def _load_processed(self, dataset_path):
        fname = next(
            f for f in sorted(os.listdir(dataset_path))
            if f.endswith("_dataset.pickle"))
        processed = legacy_load(os.path.join(dataset_path, fname))
        return _normalize_legacy_processed(processed)

    # -- dataset protocol ------------------------------------------------------

    def get_hvo_sequence(self, idx):
        """Base sequence behind processed item ``idx``.

        ``hvo_index`` holds *original-corpus* indices (reference semantics,
        kept for the evaluator's bookkeeping), but ``hvo_sequences`` is the
        filtered list — indexing it with ``hvo_index`` (as the reference
        does, dataset.py:352-356) silently returns the wrong sequence once
        any item was filtered out. ``hvo_seq_index`` carries the filtered
        positions; legacy pickles without it fall back to the reference
        behavior."""
        seq_index = getattr(self, "hvo_seq_index", None)
        if seq_index is not None:
            return self.hvo_sequences[seq_index[idx]]
        import warnings

        warnings.warn(
            "legacy pickle without hvo_seq_index: indexing hvo_sequences "
            "with corpus indices (reference dataset.py:352-356 semantics) — "
            "get_hvo_sequence may return the wrong sequence if any item was "
            "filtered out during processing", stacklevel=2)
        return self.hvo_sequences[self.hvo_index[idx]]

    def get_soundfont(self, idx):
        return self.soundfonts[idx]

    def get_voices_idx(self, idx):
        return self.voices_reduced[idx]

    def __len__(self):
        return len(self.processed_inputs)

    def __getitem__(self, idx):
        return self.processed_inputs[idx], self.processed_outputs[idx], idx


class GrooveMidiDatasetInfillingSymbolic(GrooveMidiDatasetInfilling):
    """Symbolic modality: input = the partial HVO grid itself (no audio stack);
    the reference's version 0.1.1."""

    __version__ = "0.1.1"

    def process_dataset(self, data) -> dict:
        self._finalize_save_path()
        # symbolic: no soundfont dimension — plan with a single None soundfont
        sfs_save, max_n_sf_save = self.sfs_list, self.max_n_sf
        self.sfs_list, self.max_n_sf = [None], None
        sequences, plan, unused = self._plan_items(data)
        self.sfs_list, self.max_n_sf = sfs_save, max_n_sf_save
        (sequences, seq_inputs, kept_arr, removed_arr, hvo_index, voices_reduced,
         _sfs, unused, seq_outputs, seq_index) = \
            self._materialize_voice_masking(sequences, plan, unused)
        return {
            "processed_inputs": kept_arr.astype(np.float32),
            "processed_outputs": removed_arr.astype(np.float32),
            "hvo_sequences": sequences,
            "hvo_sequences_inputs": seq_inputs,
            "hvo_sequences_outputs": seq_outputs,
            "hvo_index": hvo_index,
            "hvo_seq_index": seq_index,
            "voices_reduced": voices_reduced,
            "unused_items": unused,
        }


class GrooveMidiDatasetInfillingRandom(GrooveMidiDatasetInfilling):
    """Random-event masking: per item, ``max_aug_items`` independent draws of
    remove_random_events with a random soundfont each; the reference's
    version 0.0.0."""

    __version__ = "0.0.0"

    def __init__(self, data=None, load_dataset_path=None, **kwargs):
        self.thres_range = kwargs.get("thres_range", (0.4, 0.6))
        super().__init__(data=data, load_dataset_path=load_dataset_path, **kwargs)

    def process_dataset(self, data) -> dict:
        self._finalize_save_path()

        sequences, aug_entries, unused = [], [], []
        for hvo_idx, hvo_seq in enumerate(data):
            if len(hvo_seq.time_signatures) != 1 or hvo_seq.is_silent():
                continue
            hvo_seq = hvo_seq.copy().pad_to_length(self.max_seq_len)
            seq_pos = len(sequences)
            sequences.append(hvo_seq)
            for _ in range(self.max_aug_items):
                sf = self._rng.choice(self.sfs_list)
                aug_entries.append((seq_pos, hvo_idx, sf))

        if aug_entries:
            stacked = np.stack(
                [sequences[e[0]].hvo for e in aug_entries]).astype(np.float32)
            # vectorized remove_random_events: one threshold per entry
            m = len(aug_entries)
            thres = self._np_rng.uniform(
                self.thres_range[0], self.thres_range[1], (m, 1, 1))
            h = stacked[:, :, :N_VOICES]
            remove = (self._np_rng.random(h.shape) < thres) & (h > 0)
            remove3 = np.concatenate([remove] * 3, axis=2)
            kept = np.where(remove3, 0.0, stacked)
            removed = np.where(remove3, stacked, 0.0)
        else:
            kept = removed = np.zeros((0, self.max_seq_len, 3 * N_VOICES),
                                      np.float32)

        (seq_inputs, seq_outputs, kept_arr, removed_arr, hvo_index, seq_index,
         extras, unused) = self._collect_entries(
            sequences, aug_entries, kept, removed, unused)
        soundfonts = [sf for (sf,) in extras]
        qpms = np.asarray([s.tempos[0].qpm for s in seq_inputs], np.float32)
        processed_inputs = self._compute_msos(kept_arr, soundfonts, qpms)

        return {
            "processed_inputs": processed_inputs.astype(np.float32),
            "processed_outputs": removed_arr.astype(np.float32),
            "hvo_sequences": sequences,
            "hvo_sequences_inputs": seq_inputs,
            "hvo_sequences_outputs": seq_outputs,
            "hvo_index": hvo_index,
            "hvo_seq_index": seq_index,
            "soundfonts": soundfonts,
            "unused_items": unused,
        }


def _normalize_legacy_processed(processed: dict) -> dict:
    """Convert torch tensors / legacy HVO objects inside a loaded pickle."""
    out = {}
    for key, val in processed.items():
        if hasattr(val, "detach"):  # torch tensor
            out[key] = val.detach().cpu().numpy().astype(np.float32)
        elif key.startswith("hvo_sequences") and isinstance(val, (list, tuple)):
            out[key] = [
                s if isinstance(s, HVOSequence) else to_native(s) for s in val
            ]
        else:
            out[key] = val
    return out


def dataset_class_for_experiment(exp: str):
    """Experiment → dataset class map (reference process_dataset.py:43-48),
    extended to prefix matches so the ``*_testing`` experiment names the
    reference's testing YAMLs carry (e.g. ``InfillingClosedHH_testing``,
    configs/InfillingClosedHH_testing_training.yaml:1) resolve to the same
    class as their production experiment — the reference's exact-name
    dispatch would load ``InfillingRandom_testing`` with the wrong class."""
    if exp.startswith("InfillingClosedHH_Symbolic"):
        return GrooveMidiDatasetInfillingSymbolic
    if exp.startswith("InfillingRandom"):  # + RandomLow, *_testing variants
        return GrooveMidiDatasetInfillingRandom
    return GrooveMidiDatasetInfilling


def load_processed_dataset(load_dataset_path: str, exp: str):
    """Reference process_dataset.py:53-66 contract."""
    return dataset_class_for_experiment(exp)(load_dataset_path=load_dataset_path)
