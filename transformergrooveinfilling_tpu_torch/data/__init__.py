"""Data layer, as the JAX package's ``data/``: corpus subsetting, the
infilling task datasets, the samplers that plan them, the synthetic corpus,
the streaming augmenter, augmentation on the device (``device_pipeline``),
and MIDI in and out (``midi``: Standard MIDI Files ↔ HVO loops, GMD-style
archives → processed trees)."""

from .datasets import (
    GrooveMidiDatasetInfilling,
    GrooveMidiDatasetInfillingRandom,
    GrooveMidiDatasetInfillingSymbolic,
    dataset_class_for_experiment,
    load_processed_dataset,
)
from .device_pipeline import make_on_device_augment, random_mask_on_device
from .midi import gmd_to_processed_tree, hvo_to_midi, midi_to_hvo_sequences, parse_midi
from .samplers import (
    get_sf_list,
    get_sf_v_combinations,
    get_voice_combinations,
    get_voice_idx_for_item,
)
from .subsetter import GrooveMidiSubsetter
from .synthetic import synthetic_gmd_sequences

__all__ = [
    "get_voice_combinations",
    "get_voice_idx_for_item",
    "get_sf_v_combinations",
    "get_sf_list",
    "GrooveMidiDatasetInfilling",
    "GrooveMidiDatasetInfillingSymbolic",
    "GrooveMidiDatasetInfillingRandom",
    "load_processed_dataset",
    "dataset_class_for_experiment",
    "GrooveMidiSubsetter",
    "synthetic_gmd_sequences",
    "make_on_device_augment",
    "random_mask_on_device",
    "parse_midi",
    "midi_to_hvo_sequences",
    "hvo_to_midi",
    "gmd_to_processed_tree",
]
